"""The port's bench-leg persistence (``apex_tpu_torch.utils.bench_legs``)
against the JAX package's.

Each case of ``tests/L0/test_bench_legs.py:32-230`` writes the same legs
through both packages into two directories, the JAX package's records
tagged ``"tpu"`` and the port's ``"gpu"``, and the two give the same
records and the same assembled payloads once that tag (and the kernels
payload's metric name) is mapped and the timestamps are set aside.
"""
import json
import os
import subprocess
import sys

import pytest

from apex_tpu.utils import bench_legs as jbl

from apex_tpu_torch.utils import bench_legs as pbl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(x):
    """A JAX payload in the port's words; timestamps reduced to whether
    they are there."""
    if isinstance(x, dict):
        return {k: (bool(v) if k == "ts" else
                    {n: bool(t) for n, t in v.items()}
                    if k == "leg_timestamps" else _norm(v))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return {"tpu": "gpu",
            "pallas_kernel_microbench": "kernel_microbench"}.get(x, x) \
        if isinstance(x, str) else x


def _both(tmp_path, script):
    """Run ``script(mod, tag, d)`` for each package in its own directory;
    return the two results."""
    out = []
    for mod, tag in ((jbl, "tpu"), (pbl, "gpu")):
        d = str(tmp_path / tag)
        out.append(script(mod, tag, d))
    return out


def _flush_and_read(m, t, d):
    m.flush_leg(d, "headline", {"xla_impl_ms": 1.5}, backend=t)
    m.flush_leg(d, "rn50", {"images_per_sec": 10.0}, backend=t)
    m.flush_leg(d, "headline", {"xla_impl_ms": 1.5, "winner": "xla"},
                backend=t)
    assert not [f for f in os.listdir(d) if f.startswith(".")]
    return m.read_legs(d)


def _none_dir(m, t, d):
    m.flush_leg(None, "headline", {"x": 1}, backend="cpu")
    m.flush_leg("", "headline", {"x": 1}, backend="cpu")
    return m.read_legs(None), os.path.exists(d)


def _corrupt(m, t, d):
    m.flush_leg(d, "good", {"v": 1}, backend=t)
    with open(os.path.join(d, "bad.json"), "w") as f:
        f.write("{truncated")
    return m.read_legs(d)


def _partial_headline(m, t, d):
    m.flush_leg(d, "headline", {"n_params": 100, "complete": False,
                                "xla_impl_ms": 28.8}, backend=t)
    return m.assemble(d, "bench")


def _full_legs(m, t, d):
    m.flush_leg(d, "headline", {"n_params": 100, "complete": True,
                                "xla_impl_ms": 28.8,
                                "fused_flat_impl_ms": 19.0,
                                "optax_baseline_ms": 29.4,
                                "winner": "fused_flat"}, backend=t)
    m.flush_leg(d, "rn50", {"images_per_sec": 800.0, "batch": 128},
                backend=t)
    m.flush_leg(d, "bert_e2e", {"step_ms": 900.0}, backend=t)
    return m.assemble(d, "bench")


def _baseline_pairs(m, t, d):
    m.flush_leg(d, "headline", {"xla_impl_ms": 12.0,
                                "fused_flat_bf16grads_ms": 9.0,
                                "fused_flat_bf16state_ms": 8.0,
                                "optax_bf16grads_ms": 10.0}, backend=t)
    return m.assemble(d, "bench")


def _cpu_headline(m, t, d):
    m.flush_leg(d, "headline", {"xla_impl_ms": 16.7,
                                "optax_baseline_ms": 21.0}, backend="cpu")
    return m.assemble(d, "bench")


def _kernels(m, t, d):
    m.flush_leg(d, "attention", {"flash_attn_fwd": {"pallas_ms": 1.0,
                                                    "xla_ms": 2.0}},
                backend=t)
    m.flush_leg(d, "attn_seq_sweep",
                {"attn_seq_sweep": {"by_seq": {"64": {"speedup": 0.9}}}},
                backend=t)
    m.flush_leg(d, "attn_seq_sweep",
                {"attn_seq_sweep": {"by_seq": {"64": {"speedup": 0.9},
                                               "128": {"speedup": 1.1}}}},
                backend=t)
    m.flush_leg(d, "scalar", 3.5, backend=t)
    return m.assemble(d, "kernels")


def _empty(m, t, d):
    os.makedirs(d)
    return (m.assemble(d, "bench"),
            m.assemble(os.path.join(d, "missing"), "kernels"))


def _merge_keeps_prior(m, t, d):
    m.flush_leg(d, "headline", {"xla_impl_ms": 28.8,
                                "fused_flat_impl_ms": 19.0,
                                "complete": False}, backend=t)
    m.flush_leg(d, "headline", {"xla_impl_ms": 27.9, "complete": False},
                backend=t, merge=True)
    return m.read_legs(d), m.assemble(d, "bench")


def _merge_deep(m, t, d):
    m.flush_leg(d, "attn_seq_sweep",
                {"attn_seq_sweep": {"by_seq": {"64": 1.0, "128": 2.0,
                                               "256": 3.0}}}, backend=t)
    m.flush_leg(d, "attn_seq_sweep",
                {"attn_seq_sweep": {"by_seq": {"64": 0.9}}},
                backend=t, merge=True)
    return m.read_legs(d)


def _never_mix(m, t, d):
    m.flush_leg(d, "headline", {"xla_impl_ms": 28.8}, backend=t)
    m.flush_leg(d, "headline", {"fused_flat_impl_ms": 52.0},
                backend="cpu", merge=True)
    first = m.read_legs(d)
    m.flush_leg(d, "headline", {"fused_flat_impl_ms": 52.0}, backend="cpu")
    m.flush_leg(d, "rn50", {"ips": 1.0}, backend="cpu")
    m.flush_leg(d, "rn50", {"ips": 900.0}, backend=t)
    return first, m.read_legs(d)


def _mixed(m, t, d):
    m.flush_leg(d, "headline", {"xla_impl_ms": 16.7,
                                "optax_baseline_ms": 21.0}, backend="cpu")
    m.flush_leg(d, "rn50", {"images_per_sec": 800.0}, backend=t)
    k = os.path.join(d, "k")
    m.flush_leg(k, "attention", {"flash_attn_fwd": {"pallas_ms": 1.0}},
                backend=t)
    m.flush_leg(k, "xentropy", {"xentropy_fwd": {"pallas_ms": 9.0}},
                backend="cpu")
    m.flush_leg(k, "count", 4, backend="cpu")
    return m.assemble(d, "bench"), m.assemble(k, "kernels")


def _drop_and_flusher(m, t, d):
    flush = m.make_flusher(d, drop=("old_key",))
    flush("headline", {"xla_impl_ms": 3.0, "old_key": 1,
                       "nested": {"old_key": 2, "keep": 3}})
    flush("headline", {"fused_flat_impl_ms": 2.0}, merge=True)
    return m.read_legs(d), m.argval(["--legs", d], "--legs"), \
        m.argval(["--legs"], "--legs")


def _gpu_legs_only(m, t, d):
    m.flush_leg(d, "a", {"v": 1}, backend=t)
    m.flush_leg(d, "b", {"v": 2}, backend="cpu")
    read = m.read_tpu_legs if m is jbl else m.read_gpu_legs
    return sorted(read(d)), read(None)


SCRIPTS = [_flush_and_read, _none_dir, _corrupt, _partial_headline,
           _full_legs, _baseline_pairs, _cpu_headline, _kernels, _empty,
           _merge_keeps_prior, _merge_deep, _never_mix, _mixed,
           _drop_and_flusher, _gpu_legs_only]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[1:])
def test_port_gives_the_jax_records_and_payloads(tmp_path, script):
    j, p = _both(tmp_path, script)
    j, p = _norm(j), _norm(p)
    if script is _drop_and_flusher:
        # the flusher's second value is its directory, one per package
        j, p = (j[0], j[2]), (p[0], p[2])
    assert p == j


def test_the_jax_cases_hold_in_the_port(tmp_path):
    """The JAX tests' own assertions, in the port's words."""
    d = str(tmp_path)
    out = _partial_headline(pbl, "gpu", os.path.join(d, "a"))
    assert out["partial"] is True and out["value"] == 28.8
    assert out["vs_baseline"] is None and out["backend"] == "gpu"
    out = _full_legs(pbl, "gpu", os.path.join(d, "b"))
    assert out["value"] == 19.0
    assert out["vs_baseline"] == pytest.approx(29.4 / 19.0, abs=1e-3)
    assert _cpu_headline(pbl, "gpu", os.path.join(d, "c"))[
        "vs_baseline"] is None
    k = _kernels(pbl, "gpu", os.path.join(d, "d"))
    assert k["metric"] == "kernel_microbench" and k["compiled"] is True
    first, last = _never_mix(pbl, "gpu", os.path.join(d, "e"))
    assert first["headline"]["backend"] == "gpu"
    assert last["headline"]["data"] == {"xla_impl_ms": 28.8}
    assert last["rn50"]["data"]["ips"] == 900.0
    bench, kern = _mixed(pbl, "gpu", os.path.join(d, "f"))
    assert bench["backend"] == "mixed" and bench["value"] is None
    assert bench["detail"]["rn50"]["_backend"] == "gpu"
    assert kern["kernels"]["xentropy_fwd"]["_backend"] == "cpu"


def test_default_backend_is_the_hosts(tmp_path):
    """No ``backend`` given: "cpu" here (no card), "gpu" where torch sees
    one."""
    d = str(tmp_path)
    pbl.flush_leg(d, "x", {"v": 1})
    assert pbl.read_legs(d)["x"]["backend"] == "cpu"


def test_cli_prints_the_assembled_json(tmp_path):
    d = str(tmp_path)
    pbl.flush_leg(d, "headline", {"xla_impl_ms": 3.0}, backend="gpu")
    r = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.utils.bench_legs", d,
         "--kind", "bench"], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert r.returncode == 0, r.stderr
    payload = json.loads(r.stdout.strip().splitlines()[-1])
    assert payload["value"] == 3.0 and payload["partial"] is True
    assert payload["backend"] == "gpu"
