"""The port's tuning-profile reader (``apex_tpu_torch.utils.tuning``) and
``parallel.plan.from_tuning`` against the JAX package's.

- ``SCHEMA`` holds the JAX keys; ``schema_violations`` gives the JAX
  complaints on the JAX test's profiles and on random ones (hypothesis);
  ``get`` reads, reloads and ignores a corrupt file as the JAX reader
  does; the profile path is ``$APEX_TPU_TUNING_FILE``, else the
  package's ``tuned_defaults.json``.
- ``get_on_gpu`` (the JAX ``get_on_tpu``'s counterpart) returns the
  default while CUDA is not initialised and never initialises it (checked
  in a fresh interpreter); with CUDA up it applies the profile.
- ``from_tuning`` gives the JAX ``Plan`` on the same profile file; a plan
  tuned at another chip count is None until ``elastic.install`` hooks the
  mismatch, then a fresh search at the live count with one
  ``elastic.replan`` event (the port of ``tests/L0/test_elastic.py``'s
  ``test_from_tuning_mismatch_replans_when_installed``).
- ``resolve_overlap_fraction``: explicit > env > ``overlap_fraction_
  <scheme>`` > ``overlap_measured_fraction`` > 1.0, the JAX values.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
from hypothesis import given, settings, strategies as st

from apex_tpu.parallel import plan as jplan
from apex_tpu.utils import tuning as jtuning

import apex_tpu_torch.elastic as elastic
from apex_tpu_torch.parallel import plan as pplan
from apex_tpu_torch.resilience import guard as pguard
from apex_tpu_torch.telemetry import events
from apex_tpu_torch.telemetry.registry import MemorySink, Registry
from apex_tpu_torch.utils import tuning

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PROFILE = dict(
    name="tiny", flops=1e9, bytes_accessed=1e8, params_bytes=1 << 20,
    optimizer_bytes=3 << 20, activations_bytes=1 << 20,
    batch_bytes=1 << 16, temps_bytes=1 << 18, output_bytes=1 << 10,
    platform="cpu")


@pytest.fixture
def profile(tmp_path, monkeypatch):
    """Both packages' readers pointed at one temp profile."""
    path = tmp_path / "tuned.json"

    def write(d):
        path.write_text(json.dumps(d))
        tuning.reload()
        jtuning.reload()

    monkeypatch.setenv("APEX_TPU_TUNING_FILE", str(path))
    tuning.reload()
    jtuning.reload()
    yield write
    monkeypatch.delenv("APEX_TPU_TUNING_FILE")
    tuning.reload()
    jtuning.reload()


@pytest.fixture(autouse=True)
def _clean_hooks():
    prev = (pguard.set_resharder(None), pplan.set_replan_hook(None),
            events.set_default(None))
    yield
    pguard.set_resharder(prev[0])
    pplan.set_replan_hook(prev[1])
    events.set_default(prev[2])


def test_schema_keys_are_the_jax_keys():
    assert set(tuning.SCHEMA) == set(jtuning.SCHEMA)
    assert set(pplan.TUNING_KEYS) <= set(tuning.SCHEMA)


#: the JAX test's profiles (``tests/L0/test_tuning.py``
#: ``test_schema_violations``), good and bad
JAX_TEST_PROFILES = [
    {"flash_block_q": 128, "flash_bwd_dq_block_q": 256,
     "flash_bwd_impl": "xla", "flash_bwd_fuse": True,
     "_provenance": {"ts": "2026"}},
    {"mystery_knob": 1},
    {"flash_block_q": True},
    {"flash_block_q": -8},
    {"flash_bwd_impl": "cuda"},
    {"flash_bwd_fuse": 1},
    {"ddp_collective_scheme": "int8_blockscale",
     "collective_min_compress_bytes": 4096},
    {"ddp_collective_scheme": "zstd"},
    {"collective_min_compress_bytes": 0},
    {"plan_dp": 8, "plan_tp": 2, "plan_sp_strategy": "ring",
     "plan_zero": False, "overlap_measured_fraction": 0.4},
    {"overlap_measured_fraction": 1.5, "plan_sp_strategy": "tree"},
]


@pytest.mark.parametrize("i", range(len(JAX_TEST_PROFILES)))
def test_schema_violations_match_jax(i):
    prof = JAX_TEST_PROFILES[i]
    assert tuning.schema_violations(prof) == jtuning.schema_violations(prof)


_VALUES = st.one_of(st.booleans(), st.integers(-4, 4096),
                    st.floats(-1.0, 2.0, allow_nan=False),
                    st.sampled_from(["fp32", "bf16", "int8_blockscale",
                                     "adasum", "zero1", "off", "ring",
                                     "fast", "xla", "pallas", "cuda"]))


@settings(max_examples=60, deadline=None, database=None)
@given(st.dictionaries(st.sampled_from(sorted(jtuning.SCHEMA)
                                       + ["_meta", "mystery"]),
                       _VALUES, max_size=6))
def test_random_profiles_validate_as_in_jax(prof):
    assert tuning.schema_violations(prof) == jtuning.schema_violations(prof)


def test_get_reads_reloads_and_matches_jax(profile):
    assert tuning.get("flash_block_q") is None
    assert tuning.get("flash_block_q", 512) == 512
    profile({"flash_block_q": 256, "plan_dp": 4})
    assert tuning.get("flash_block_q", 512) == 256 == \
        jtuning.get("flash_block_q", 512)
    profile({"flash_block_q": 128})
    assert tuning.get("flash_block_q", 512) == 128
    assert tuning.get("plan_dp") is None
    assert tuning.profile_path() == os.environ["APEX_TPU_TUNING_FILE"]


def test_corrupt_profile_is_ignored(tmp_path, monkeypatch):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    monkeypatch.setenv("APEX_TPU_TUNING_FILE", str(p))
    tuning.reload()
    assert tuning.get("anything", "fallback") == "fallback"
    p.write_text("[1, 2]")                           # not a dict
    tuning.reload()
    assert tuning.get("anything", "fallback") == "fallback"
    monkeypatch.delenv("APEX_TPU_TUNING_FILE")
    tuning.reload()
    assert tuning.profile_path() == os.path.join(
        ROOT, "apex_tpu_torch", "tuned_defaults.json")


def test_get_on_gpu_applies_only_with_cuda_up(profile, monkeypatch):
    import torch
    profile({"zero_impl": "fused"})
    assert not torch.cuda.is_initialized()
    assert tuning.get_on_gpu("zero_impl", "xla") == "xla"
    assert not torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert tuning.get_on_gpu("zero_impl", "xla") == "fused"


def test_get_on_gpu_never_initialises_cuda():
    """In a fresh interpreter, with a profile on disk: the default comes
    back and CUDA stays down (the JAX test's side-effect check)."""
    code = (
        "import json, os, tempfile, torch\n"
        "p = os.path.join(tempfile.mkdtemp(), 'tuned.json')\n"
        "json.dump({'zero_impl': 'fused'}, open(p, 'w'))\n"
        "os.environ['APEX_TPU_TUNING_FILE'] = p\n"
        "from apex_tpu_torch.utils import tuning\n"
        "assert tuning.get_on_gpu('zero_impl', 'xla') == 'xla'\n"
        "assert not torch.cuda.is_initialized(), 'initialised CUDA'\n"
        "from apex_tpu_torch.parallel import plan\n"
        "assert plan.from_tuning() is None\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('SIDE-EFFECT-FREE')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr
    assert "SIDE-EFFECT-FREE" in r.stdout


_PLAN_PROFILES = [
    {},
    {"plan_dp": 8},
    {"plan_dp": 2, "plan_tp": 2, "plan_sp": 2, "plan_sp_strategy": "ring",
     "plan_update_sharding": "zero1",
     "plan_collective_scheme": "int8_blockscale",
     "plan_allgather_scheme": "bf16"},
    {"plan_dp": 1, "plan_pp_stages": 4, "plan_pp_microbatches": 8,
     "plan_ep": 2, "plan_zero": True},
    {"plan_tp": 4},                                  # no plan_dp: none
]


@pytest.mark.parametrize("i", range(len(_PLAN_PROFILES)))
def test_from_tuning_gives_the_jax_plan(profile, i):
    profile(_PLAN_PROFILES[i])
    jp = jplan.from_tuning(tpu_only=False)
    pp = pplan.from_tuning(gpu_only=False)
    if jp is None:
        assert pp is None
        return
    assert pp.knobs() == jp.knobs() and pp.chips == jp.chips
    # matching chips gives the plan, another count None (no hook)
    assert pplan.from_tuning(pp.chips, gpu_only=False).knobs() == pp.knobs()
    assert pplan.from_tuning(pp.chips + 1, gpu_only=False) is None
    assert jplan.from_tuning(pp.chips + 1, tpu_only=False) is None
    # the runtime read applies nothing off the card
    assert pplan.from_tuning() is None


def test_from_tuning_mismatch_replans_when_installed(profile):
    profile({"plan_dp": 8})
    assert pplan.from_tuning(4, gpu_only=False) is None
    reg = Registry(sink=MemorySink(), flush_interval=0, rank0_only=False)
    events.set_default(reg)
    er = elastic.install(profile=pplan.ModelProfile(**TINY_PROFILE))
    assert elastic.installed() is er
    replanned = pplan.from_tuning(4, gpu_only=False)
    assert replanned is not None and replanned.chips == 4
    # the JAX search on the same profile picks the same plan
    jwin = jplan.search(jplan.ModelProfile(**TINY_PROFILE), 4)[0]
    assert replanned.knobs() == jwin.knobs()
    assert pplan.from_tuning(8, gpu_only=False).dp == 8   # no hook call
    evs = [r for r in reg.flush() if r.get("name") == "elastic.replan"]
    assert len(evs) == 1 and evs[0]["fields"]["old_knobs"]["dp"] == 8
    elastic.uninstall()
    assert elastic.installed() is None
    assert pplan.from_tuning(4, gpu_only=False) is None


@pytest.mark.parametrize("explicit,env,prof,scheme", [
    (None, None, {}, None),
    (0.3, "0.7", {"overlap_measured_fraction": 0.1}, "bf16"),
    (None, "0.7", {"overlap_measured_fraction": 0.1}, "bf16"),
    (None, None, {"overlap_measured_fraction": 0.1}, "bf16"),
    (None, None, {"overlap_measured_fraction": 0.1,
                  "overlap_fraction_bf16": 0.6}, "bf16"),
    (None, None, {"overlap_measured_fraction": 0.1,
                  "overlap_fraction_bf16": 0.6}, "fp32"),
    (None, None, {"overlap_fraction_int8_blockscale": 0.2},
     "int8_blockscale"),
    (None, None, {"overlap_fraction_int8_blockscale": 0.2}, None),
    (1.7, None, {}, None),
])
def test_resolve_overlap_fraction_matches_jax(profile, monkeypatch,
                                              explicit, env, prof, scheme):
    profile(prof)
    if env is None:
        monkeypatch.delenv(pplan.ENV_OVERLAP, raising=False)
    else:
        monkeypatch.setenv(pplan.ENV_OVERLAP, env)
    got = pplan.resolve_overlap_fraction(explicit, scheme=scheme)
    assert got == jplan.resolve_overlap_fraction(explicit, scheme=scheme)


def test_predict_prices_the_profile_fraction_as_jax(profile):
    """``predict`` charges the dp wire at the profile's per-scheme
    fraction in both packages."""
    profile({"overlap_fraction_bf16": 0.25})
    jp = jplan.predict(jplan.ModelProfile(**TINY_PROFILE),
                       jplan.Plan(dp=4, collective_scheme="bf16"))
    pp = pplan.predict(pplan.ModelProfile(**TINY_PROFILE),
                       pplan.Plan(dp=4, collective_scheme="bf16"))
    assert pp.predicted_step_ms == pytest.approx(jp.predicted_step_ms,
                                                 rel=1e-12)
    assert dataclasses.asdict(pp)["breakdown"].keys() == \
        dataclasses.asdict(jp)["breakdown"].keys()
