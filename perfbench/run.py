"""The benchmark of apex_tpu_torch: one run of one cell.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  Prints progress and, as its last lines,
every number compared beside its limit on standard error, and one JSON
object as the last line of standard output.  Exits non-zero with no
result where the cell's cards are missing, a file is missing, or the
process holds JAX or the JAX package after the window."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """The port's built-in routes, with no tuning profile and no override
    from the environment; every cache inside the checkout; few host
    threads."""
    for key in list(os.environ):
        if key.startswith("APEX_TPU_"):
            del os.environ[key]
    os.environ["APEX_TPU_TUNING_FILE"] = str(
        ROOT / "perfbench" / "no_tuning_profile.json")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    try:
        from perfbench.lib import harness
    except ImportError as e:
        print(f"[perfbench] cannot load the harness: {e}", file=sys.stderr)
        return 2
    try:
        out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START)
    except (harness.CellError, ImportError) as e:
        harness.log(f"no result: {e}")
        return 2
    found = harness.forbidden_modules()
    if found:
        harness.log(f"no result: the process holds {found}")
        return 3
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
                    f"{ok}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
