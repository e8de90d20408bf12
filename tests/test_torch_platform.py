"""The port's backend helpers (``apex_tpu_torch.utils.platform``) and test
harness (``apex_tpu_torch.testing``), and the public names of this slice's
modules against the JAX package's.

This host has no card, so the probe fails here with its detail, and
``ensure_live_backend`` raises where the JAX helper would pin the CPU.
``force_cpu`` / ``cpu_platform`` hide the card through
``CUDA_VISIBLE_DEVICES`` and restore it, and both refuse a process whose
CUDA is up.  ``skip_if_no_gpu`` / ``skip_if_cpu`` skip when the test runs.
"""
import importlib
import inspect
import os
import subprocess
import sys

import pytest
import torch

from apex_tpu_torch import testing
from apex_tpu_torch.utils import build, platform, tuning

HIDE = platform.HIDE_ENV


@pytest.fixture
def env(monkeypatch):
    """``CUDA_VISIBLE_DEVICES`` restored after the test, whatever the
    helpers did to it."""
    monkeypatch.delenv(HIDE, raising=False)
    return monkeypatch


def test_backends_initialized_is_false_here_and_follows_torch(monkeypatch):
    assert platform.backends_initialized() is False
    assert testing.backends_initialized is platform.backends_initialized
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert platform.backends_initialized() is True
    # the tuning reader asks the same question
    assert tuning._cuda_initialized() is True


def test_tuning_reader_asks_platform(monkeypatch):
    monkeypatch.setattr(platform, "backends_initialized", lambda: True)
    assert tuning._cuda_initialized() is True
    monkeypatch.setattr(platform, "backends_initialized", lambda: False)
    assert tuning._cuda_initialized() is False


def test_force_cpu_hides_the_card(env):
    platform.force_cpu()
    assert os.environ[HIDE] == ""
    platform.force_cpu(4)              # a world of 4 is 4 gloo processes
    assert os.environ[HIDE] == ""
    with pytest.raises(ValueError):
        platform.force_cpu(0)
    # a child process sees no card
    r = subprocess.run([sys.executable, "-c",
                        "import torch; print(torch.cuda.device_count())"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "0"


@pytest.mark.parametrize("before", [None, "0", "1,2", ""])
def test_cpu_platform_restores_the_variable(env, before):
    if before is not None:
        env.setenv(HIDE, before)
    with testing.cpu_platform(2):
        assert os.environ[HIDE] == ""
    assert os.environ.get(HIDE) == before


def test_cpu_platform_restores_after_an_exception(env):
    env.setenv(HIDE, "3")
    with pytest.raises(KeyError):
        with platform.cpu_platform():
            raise KeyError("inside")
    assert os.environ[HIDE] == "3"


@pytest.mark.parametrize("helper", ["force_cpu", "cpu_platform"])
def test_helpers_refuse_a_live_cuda(env, monkeypatch, helper):
    """torch cannot take a live CUDA context down: both raise, and leave
    the variable as it was."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialised"):
        if helper == "force_cpu":
            platform.force_cpu()
        else:
            with platform.cpu_platform():
                pass
    assert HIDE not in os.environ


def test_probe_fails_here_with_its_detail(env):
    probe = platform.probe_ambient_backend(timeout=120)
    assert not probe and probe.ok is False
    assert probe.detail.startswith("probe exited rc=")
    assert "ProbeResult(ok=False" in repr(probe)


def test_probe_timeout_is_reported(env):
    probe = platform.probe_ambient_backend(timeout=0.001)
    assert not probe and "timeout" in probe.detail


def test_probe_passes_where_the_subprocess_succeeds(monkeypatch):
    monkeypatch.setattr(platform, "_PROBE", "pass")
    probe = platform.probe_ambient_backend(timeout=120)
    assert probe and probe.detail == "ok"


def test_ensure_live_backend_raises_instead_of_pinning_the_cpu(env):
    """The JAX helper pins the CPU after a failed probe; the port raises
    with the probe's detail and leaves the environment alone."""
    with pytest.raises(RuntimeError, match="no live CUDA backend.*rc="):
        platform.ensure_live_backend(probe_timeout=120)
    assert HIDE not in os.environ


def test_ensure_live_backend_answers_without_a_probe(env, monkeypatch):
    def no_probe(*a, **k):
        raise AssertionError("probed")
    monkeypatch.setattr(platform, "probe_ambient_backend", no_probe)
    platform.force_cpu()                      # the caller's choice
    assert platform.ensure_live_backend() == "cpu"
    env.delenv(HIDE)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert platform.ensure_live_backend() == "cuda"


def test_ensure_live_backend_after_a_good_probe(env, monkeypatch):
    monkeypatch.setattr(platform, "probe_ambient_backend",
                        lambda t: platform.ProbeResult(True, "ok"))
    assert platform.ensure_live_backend() == "cuda"


def test_enable_compile_cache_moves_the_build_root(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_ROOT", build.BUILD_ROOT)
    assert platform.enable_compile_cache() == build.BUILD_ROOT
    assert platform.enable_compile_cache(str(tmp_path)) == tmp_path
    assert build.BUILD_ROOT == tmp_path


def test_on_gpu_and_the_skips_decide_when_the_test_runs(monkeypatch):
    ran = []

    @testing.skip_if_no_gpu
    def needs_card():
        ran.append("card")
        return 1

    @testing.skip_if_cpu
    def not_on_cpu():
        ran.append("not cpu")
        return 2

    assert testing.on_gpu() is False
    for fn in (needs_card, not_on_cpu):
        with pytest.raises(pytest.skip.Exception):
            fn()
    assert ran == []
    # decided at call time: the same functions run once a card shows up
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert testing.on_gpu() is True
    assert (needs_card(), not_on_cpu()) == (1, 2)
    assert ran == ["card", "not cpu"]
    assert needs_card.__name__ == "needs_card"


# -- every JAX public name has a counterpart ---------------------------------

#: JAX name -> the port's name where the TPU becomes the card
RENAMED = {
    "testing": {"on_tpu": "on_gpu", "skip_if_no_tpu": "skip_if_no_gpu"},
    "utils.bench_legs": {"read_tpu_legs": "read_gpu_legs"},
}
#: JAX public names with no counterpart, with the reason (none here)
NO_COUNTERPART = {}


def _public(mod):
    return getattr(mod, "__all__", None) or [
        n for n, v in vars(mod).items() if not n.startswith("_")
        and not inspect.ismodule(v)
        and getattr(v, "__module__", mod.__name__) == mod.__name__]


@pytest.mark.parametrize("module", ["utils.platform", "testing",
                                    "utils.host_pack", "utils.bench_legs",
                                    "interop"])
def test_every_jax_public_name_has_a_counterpart(module):
    jm = importlib.import_module(f"apex_tpu.{module}")
    tm = importlib.import_module(f"apex_tpu_torch.{module}")
    names = _public(jm)
    assert names
    skip = NO_COUNTERPART.get(module, set())
    renamed = RENAMED.get(module, {})
    assert skip <= set(names) and set(renamed) <= set(names)
    missing = [n for n in names if n not in skip
               and not hasattr(tm, renamed.get(n, n))]
    assert not missing, missing
    assert not any(hasattr(tm, n) for n in list(skip) + list(renamed))
    # the JAX signature's parameters are the counterpart's
    for n in names:
        if n in skip:
            continue
        jf, tf = getattr(jm, n), getattr(tm, renamed.get(n, n))
        if inspect.isfunction(jf):
            assert list(inspect.signature(jf).parameters) == \
                list(inspect.signature(tf).parameters), n
