"""``CONTROL.json`` — the run controller's decision ledger.

Counterpart of ``apex_tpu/control/ledger.py``: the same schema, auditor
and rendering, so either package's auditor accepts the other's artifact.
Every window the :class:`~apex_tpu_torch.control.controller.RunController`
evaluates, and every decision it takes (acted / suppressed by cooldown /
suppressed by max-actions / failed and reverted), lands in one
schema-validated artifact written on the same flight-recorder destination
chain as ``GOODPUT.json``: exit, preempt and crash all leave the audit
trail.  The shape:

.. code-block:: python

    {
      "kind": "control_ledger", "version": 1, "ts": "...Z",
      "status": "completed",            # the GuardReport status
      "enabled": True,
      "windows": 12,                    # health-check windows evaluated
      "max_actions": 3,                 # the per-run action bound
      "actions_fired": 1,
      "suppressed_cooldown": 2,
      "suppressed_max_actions": 0,
      "failed_reverted": 0,
      "policies": [                     # the armed policy table
        {"name": "exposed_comm_ceiling", "signal": "exposed_comm_fraction",
         "lo": None, "hi": 0.25, "k_consecutive": 2,
         "cooldown_windows": 3, "action": "comm_retune"},
        ...
      ],
      "decisions": [                    # chronological audit rows
        {"window": 4, "step": 8, "policy": "exposed_comm_ceiling",
         "signal": "exposed_comm_fraction", "value": 0.41,
         "lo": None, "hi": 0.25, "action": "comm_retune",
         "outcome": "acted", "detail": {"from": "fp32", "to": "bf16"}},
        ...
      ],
    }

The writer validates (:func:`control_violations` runs before every
:func:`write_doc`), and the same auditor re-runs on a loaded artifact.
The module imports nothing but the standard library, so tooling can load
it alone to audit an artifact.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, List, Optional

__all__ = ["ARTIFACT_NAME", "OUTCOMES", "control_violations",
           "build_doc", "write_doc", "format_control", "load_artifact",
           "cli"]

ARTIFACT_NAME = "CONTROL.json"

#: every decision row names exactly one of these
OUTCOMES = ("acted", "suppressed_cooldown", "suppressed_max_actions",
            "failed_reverted")

#: outcome -> the counter field it tallies into
_OUTCOME_COUNTER = {
    "acted": "actions_fired",
    "suppressed_cooldown": "suppressed_cooldown",
    "suppressed_max_actions": "suppressed_max_actions",
    "failed_reverted": "failed_reverted",
}

_COUNTER_FIELDS = ("windows", "max_actions", "actions_fired",
                   "suppressed_cooldown", "suppressed_max_actions",
                   "failed_reverted")


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def control_violations(doc: Any) -> List[str]:
    """Audit a control-ledger doc; empty list = valid.  The checks the
    writer enforces before the artifact exists and a loader re-enforces
    after — kind/version, non-negative integer counters,
    the ``actions_fired <= max_actions`` safety bound, a well-formed
    policy table, and decision rows whose outcomes both come from
    :data:`OUTCOMES` and tally exactly to the counters."""
    out: List[str] = []
    if not isinstance(doc, dict):
        return [f"not a dict: {type(doc).__name__}"]
    if doc.get("kind") != "control_ledger":
        out.append(f"bad kind {doc.get('kind')!r}")
    if doc.get("version") != 1:
        out.append(f"bad version {doc.get('version')!r}")
    for field in _COUNTER_FIELDS:
        v = doc.get(field)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            out.append(f"bad {field} {v!r}")
    if not isinstance(doc.get("enabled"), bool):
        out.append(f"bad enabled {doc.get('enabled')!r}")
    if (isinstance(doc.get("actions_fired"), int)
            and isinstance(doc.get("max_actions"), int)
            and doc["actions_fired"] > doc["max_actions"]):
        out.append(f"actions_fired {doc['actions_fired']} exceeds "
                   f"max_actions {doc['max_actions']}")

    policies = doc.get("policies")
    names = set()
    if not isinstance(policies, list):
        out.append(f"bad policies {type(policies).__name__}")
    else:
        for i, p in enumerate(policies):
            if not isinstance(p, dict):
                out.append(f"policies[{i}] not a dict")
                continue
            for key in ("name", "signal", "action"):
                if not isinstance(p.get(key), str) or not p.get(key):
                    out.append(f"policies[{i}].{key} bad: {p.get(key)!r}")
            for key in ("lo", "hi"):
                if p.get(key) is not None and not _is_num(p.get(key)):
                    out.append(f"policies[{i}].{key} bad: {p.get(key)!r}")
            if p.get("lo") is None and p.get("hi") is None:
                out.append(f"policies[{i}] has no band edge")
            k = p.get("k_consecutive")
            if not isinstance(k, int) or isinstance(k, bool) or k < 1:
                out.append(f"policies[{i}].k_consecutive bad: {k!r}")
            cd = p.get("cooldown_windows")
            if not isinstance(cd, int) or isinstance(cd, bool) or cd < 0:
                out.append(f"policies[{i}].cooldown_windows bad: {cd!r}")
            if isinstance(p.get("name"), str):
                names.add(p["name"])

    decisions = doc.get("decisions")
    tallies = {c: 0 for c in _OUTCOME_COUNTER.values()}
    if not isinstance(decisions, list):
        out.append(f"bad decisions {type(decisions).__name__}")
    else:
        for i, d in enumerate(decisions):
            if not isinstance(d, dict):
                out.append(f"decisions[{i}] not a dict")
                continue
            outcome = d.get("outcome")
            if outcome not in OUTCOMES:
                out.append(f"decisions[{i}].outcome bad: {outcome!r}")
            else:
                tallies[_OUTCOME_COUNTER[outcome]] += 1
            if names and d.get("policy") not in names:
                out.append(f"decisions[{i}].policy {d.get('policy')!r} "
                           "not in the policy table")
            for key in ("window", "step"):
                v = d.get(key)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    out.append(f"decisions[{i}].{key} bad: {v!r}")
            if not _is_num(d.get("value")):
                out.append(f"decisions[{i}].value bad: {d.get('value')!r}")
            for key in ("signal", "action"):
                if not isinstance(d.get(key), str):
                    out.append(f"decisions[{i}].{key} bad: {d.get(key)!r}")
        for counter, n in tallies.items():
            if isinstance(doc.get(counter), int) and doc[counter] != n:
                out.append(f"{counter} {doc[counter]} != {n} matching "
                           "decision rows")
    return out


def build_doc(*, enabled: bool, windows: int, max_actions: int,
              policies: List[dict], decisions: List[dict],
              status: Optional[str] = None) -> dict:
    """Assemble the ledger doc; counters derive FROM the decision rows
    (one source of truth — the consistency check above can then never
    trip on the writer's own output)."""
    tallies = {c: 0 for c in _OUTCOME_COUNTER.values()}
    for d in decisions:
        counter = _OUTCOME_COUNTER.get(d.get("outcome"))
        if counter is not None:
            tallies[counter] += 1
    doc = {
        "kind": "control_ledger",
        "version": 1,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "enabled": bool(enabled),
        "windows": int(windows),
        "max_actions": int(max_actions),
        **tallies,
        "policies": list(policies),
        "decisions": list(decisions),
    }
    if status is not None:
        doc["status"] = str(status)
    return doc


def write_doc(doc: dict, path: Optional[str] = None,
              directory: Optional[str] = None) -> Optional[str]:
    """Write ``doc`` as ``CONTROL.json`` (atomic replace, writer-
    validates).  ``path`` wins over ``directory``/``ARTIFACT_NAME``;
    with neither, returns None."""
    bad = control_violations(doc)
    if bad:
        raise ValueError("control ledger fails its schema: "
                         + "; ".join(bad[:4]))
    if path is None:
        if directory is None:
            return None
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, ARTIFACT_NAME)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path


def format_control(doc: dict) -> str:
    """Human table: counters line + one row per decision."""
    lines = [
        "control ledger  status={} windows={} actions={}/{} "
        "suppressed={}+{} failed={}".format(
            doc.get("status", "?"), doc.get("windows", 0),
            doc.get("actions_fired", 0), doc.get("max_actions", 0),
            doc.get("suppressed_cooldown", 0),
            doc.get("suppressed_max_actions", 0),
            doc.get("failed_reverted", 0)),
    ]
    for d in doc.get("decisions", []):
        lines.append(
            "  w{:<4} step {:<6} {:<24} {}={:<10.4g} -> {:<14} {}".format(
                d.get("window", 0), d.get("step", 0),
                str(d.get("policy", "?")), str(d.get("signal", "?")),
                float(d.get("value", 0.0)), str(d.get("action", "?")),
                str(d.get("outcome", "?"))))
    return "\n".join(lines)


def load_artifact(path: str) -> dict:
    """Read a ``CONTROL.json`` (or a run directory containing one) and
    audit it — a loaded artifact that fails its own schema raises."""
    if os.path.isdir(path):
        cand = os.path.join(path, ARTIFACT_NAME)
        if not os.path.exists(cand):
            raise ValueError(f"{path}: no {ARTIFACT_NAME} in directory")
        path = cand
    with open(path) as f:
        doc = json.load(f)
    bad = control_violations(doc)
    if bad:
        raise ValueError(f"{path}: invalid control ledger: "
                         + "; ".join(bad[:4]))
    return doc


def cli(argv=None) -> int:
    """``python -m apex_tpu_torch.telemetry control <CONTROL.json|run-dir>``:
    render the decision table.  Exit 0 on a valid artifact."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="apex_tpu_torch.telemetry control",
        description="render a CONTROL.json decision ledger")
    ap.add_argument("path", help="CONTROL.json or a run directory")
    ns = ap.parse_args(argv)
    try:
        doc = load_artifact(ns.path)
    except (OSError, ValueError) as e:
        print(f"error: {e}")
        return 1
    print(format_control(doc))
    return 0
