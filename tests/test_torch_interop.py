"""The port's torch-loop facade (``apex_tpu_torch.interop``) against the
JAX package's.

The same torch modules, data and steps through the JAX
``TorchFusedOptimizer`` (the port's JAX reference, DLPack into JAX
optimizers) and through the port's (state in the port): FusedAdam,
FusedLAMB and FusedSGD, both impls, 3 steps, fp32 parameters within 1e-6.
The port takes its host_pack path exactly where the JAX facade takes its
packed one, and its per-leaf path elsewhere; the device path (every tensor
on the card) is the same flat math, checked here on CPU tensors and on the
card in ``tests/test_torch_cuda_kernels.py``.  The cases of
``tests/L0/test_interop.py`` hold in the port too.
"""
import copy

import numpy as np
import pytest
import torch

import apex_tpu.optimizers as jopt
from apex_tpu.interop import TorchFusedOptimizer as JTorchFusedOptimizer

import apex_tpu_torch.optimizers as popt
from apex_tpu_torch.interop import (TorchFusedOptimizer, from_torch,
                                    to_torch)
from apex_tpu_torch.utils import logging as plogging

from _torch_port import amp_uninit  # noqa: F401  (autouse)

OPTS = {"FusedAdam": dict(lr=1e-2, weight_decay=0.01),
        "FusedLAMB": dict(lr=1e-2, weight_decay=0.01),
        "FusedSGD": dict(lr=0.1, momentum=0.9, weight_decay=1e-4)}


def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 4))


def _train(model, opt, steps=3, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(32, 8, generator=g).to(dtype)
    y = torch.randn(32, 4, generator=g).to(dtype)
    for _ in range(steps):
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        opt.step()


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_facade_matches_the_jax_facade(name, impl):
    jm = _model()
    pm = copy.deepcopy(jm)
    jo = JTorchFusedOptimizer(jm.parameters(),
                              getattr(jopt, name)(impl=impl, **OPTS[name]))
    po = TorchFusedOptimizer(pm.parameters(),
                             getattr(popt, name)(impl=impl, **OPTS[name]))
    _train(jm, jo)
    _train(pm, po)
    for a, b in zip(jm.parameters(), pm.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-6, rtol=0)
    # the path: the JAX packed path <-> host_pack, else per-leaf
    jpacked = jo._native_fast_path_ok([p.grad for p in jm.parameters()])
    assert po.last_path == ("host_pack" if jpacked else "per_leaf")
    assert jpacked == (impl == "fused")


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_facade_matches_torch_adamw(impl):
    model = _model(3)
    ref = copy.deepcopy(model)
    opt = TorchFusedOptimizer(model.parameters(),
                              popt.FusedAdam(lr=1e-2, weight_decay=0.01,
                                             impl=impl))
    ropt = torch.optim.AdamW(ref.parameters(), lr=1e-2, weight_decay=0.01,
                             eps=1e-8)
    _train(model, opt, steps=5)
    _train(ref, ropt, steps=5)
    for a, b in zip(model.parameters(), ref.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_device_path_is_the_host_pack_paths_math(name):
    """The device path (flatten, ``step_flat``, unflatten into ``p.data``)
    run on CPU tensors gives the host_pack path's bits."""
    a, b = _model(5), _model(5)
    oa = TorchFusedOptimizer(a.parameters(),
                             getattr(popt, name)(impl="fused", **OPTS[name]))
    ob = TorchFusedOptimizer(b.parameters(),
                             getattr(popt, name)(impl="fused", **OPTS[name]))
    ob._path = lambda gs: "device"
    _train(a, oa)
    _train(b, ob)
    assert (oa.last_path, ob.last_path) == ("host_pack", "device")
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)


def test_flat_paths_equal_the_functional_step_flat():
    """A fused optimizer through the facade is ``step_flat`` on the same
    flat gradients, bit for bit (the card's check, phase 30 (g), at a small
    size)."""
    model = _model(7)
    params0 = [p.detach().clone() for p in model.parameters()]
    opt = TorchFusedOptimizer(model.parameters(),
                              popt.FusedLAMB(lr=1e-3, impl="fused"))
    ref = popt.FusedLAMB(lr=1e-3, impl="fused")
    st = ref.init(params0)
    g = torch.Generator().manual_seed(8)
    x, y = torch.randn(16, 8, generator=g), torch.randn(16, 4, generator=g)
    for _ in range(4):
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        grads = [p.grad.clone() for p in model.parameters()]
        opt.step()
        st = ref.step_flat(st, ref.flattener.flatten(grads))
        for p, q in zip(model.parameters(), ref.model_params(st)):
            assert torch.equal(p.detach(), q)


def test_scale_and_explicit_grads():
    p = torch.nn.Parameter(torch.ones(4, 8))
    opt = TorchFusedOptimizer([p], popt.FusedSGD(lr=0.1))
    opt.step(grads=[torch.full((4, 8), 64.0)], scale=64.0)
    np.testing.assert_allclose(p.detach().numpy(), np.ones((4, 8)) - 0.1,
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_torch_side_mutation_honored(impl):
    p = torch.nn.Parameter(torch.zeros(4, 8))
    opt = TorchFusedOptimizer([p], popt.FusedSGD(lr=0.5, impl=impl))
    with torch.no_grad():
        p.copy_(torch.ones(4, 8))      # e.g. load_state_dict
    opt.step(grads=[torch.full((4, 8), 1.0)])
    np.testing.assert_allclose(p.detach().numpy(), np.full((4, 8), 0.5),
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_state_dict_round_trip(impl):
    p = torch.nn.Parameter(torch.ones(8, 8))
    opt = TorchFusedOptimizer([p], popt.FusedAdam(lr=1e-2, impl=impl))
    p.grad = torch.full((8, 8), 0.5)
    opt.step()
    sd = opt.state_dict()
    after_1 = p.detach().clone()
    opt.step()
    after_2 = p.detach().clone()
    p2 = torch.nn.Parameter(torch.zeros(8, 8))
    opt2 = TorchFusedOptimizer([p2], popt.FusedAdam(lr=1e-2, impl=impl))
    opt2.load_state_dict(sd)
    assert torch.equal(p2.detach(), after_1)
    p2.grad = torch.full((8, 8), 0.5)
    opt2.step()
    assert torch.equal(p2.detach(), after_2)
    # the saved state is a copy: later steps did not change it
    assert int(sd["state"].count) == 1


def test_load_state_dict_reads_index_keyed_params():
    ps = [torch.nn.Parameter(torch.zeros(2)) for _ in range(12)]
    opt = TorchFusedOptimizer(ps, popt.FusedSGD(lr=0.1))
    sd = opt.state_dict()
    sd["params"] = {f"p{i}": torch.full((2,), float(i)) for i in range(12)}
    opt.load_state_dict(sd)
    assert [float(p.detach()[0]) for p in ps] == \
        [float(i) for i in range(12)]


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_many_params_order_stable(impl):
    torch.manual_seed(3)
    ps = [torch.nn.Parameter(torch.randn(3, 4) * (i + 1)) for i in range(12)]
    ref = [p.detach().clone() for p in ps]
    opt = TorchFusedOptimizer(ps, popt.FusedSGD(lr=0.1, impl=impl))
    opt.step(grads=[torch.full((3, 4), float(i)) for i in range(12)])
    for i, (p, r) in enumerate(zip(ps, ref)):
        np.testing.assert_allclose(p.detach().numpy(), (r - 0.1 * i).numpy(),
                                   atol=1e-6, err_msg=f"param {i}")


@pytest.mark.parametrize("case", ["strided", "bf16"])
def test_the_per_leaf_path_where_jax_takes_its_slow_path(case, monkeypatch,
                                                       capsys):
    """Strided or non-fp32 CPU tensors take the per-leaf path with one
    warning a process, as the JAX facade does, and still train."""
    monkeypatch.setattr(plogging, "_warned", set())
    if case == "strided":
        p = torch.nn.Parameter(torch.randn(4, 8).t())
        g = torch.ones(8, 4)
    else:
        p = torch.nn.Parameter(torch.ones(8, 4, dtype=torch.bfloat16))
        g = torch.ones(8, 4, dtype=torch.bfloat16)
    before = p.detach().clone()
    opt = TorchFusedOptimizer([p], popt.FusedSGD(lr=0.5, impl="fused"))
    jo = JTorchFusedOptimizer([p], jopt.FusedSGD(lr=0.5, impl="fused"))
    assert not jo._native_fast_path_ok([g])
    capsys.readouterr()
    opt.step(grads=[g])
    assert "per-leaf path" in capsys.readouterr().err
    assert opt.last_path == "per_leaf"
    np.testing.assert_allclose(p.detach().float().numpy(),
                               (before.float() - 0.5).numpy(), rtol=1e-6)
    opt.step(grads=[g])
    assert capsys.readouterr().err == ""   # warned once only


def test_hyperparameter_mutation_is_honored():
    p = torch.nn.Parameter(torch.zeros(8, 4))
    opt = TorchFusedOptimizer([p], popt.FusedSGD(lr=0.5, impl="fused"))
    opt.step(grads=[torch.ones(8, 4)])
    opt.optimizer.lr = 0.25
    opt.step(grads=[torch.ones(8, 4)])
    np.testing.assert_allclose(p.detach().numpy(), np.full((8, 4), -0.75),
                               rtol=1e-6)


def test_missing_grad_and_empty_list_raise():
    with pytest.raises(ValueError):
        TorchFusedOptimizer([], popt.FusedSGD(lr=0.1))
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(RuntimeError, match="no .grad"):
        TorchFusedOptimizer([p], popt.FusedSGD(lr=0.1)).step()


def test_from_and_to_torch_are_the_identity():
    t = torch.arange(12.0).reshape(3, 4).requires_grad_(True)
    x = from_torch(t)
    assert not x.requires_grad and x.data_ptr() == t.data_ptr()
    assert torch.equal(to_torch(x), t.detach())
    s = t.detach().t()
    assert from_torch(s).is_contiguous() and torch.equal(from_torch(s), s)
    b = torch.arange(8, dtype=torch.bfloat16)
    assert to_torch(from_torch(b)).dtype == torch.bfloat16
