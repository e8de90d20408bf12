"""The RNN toolkit of the PyTorch port against the JAX package's (the
counterpart of ``tests/L0/test_rnn.py``, held to the JAX containers rather
than to ``torch.nn``), and the byte mLSTM's training step against the model
built from the JAX package.

The same numpy weights (``rnn_params_from_jax``) and inputs go through
both packages in fp32: outputs and final hidden states within 1e-5
(elementwise against max(1, |ref|)), gradients within 1e-4 on the peak
rule (the floor of 1 lowered to the tensor's largest |value|: gradients
lie far below 1), since the time loop sums products in other orders over
T steps.  Dropout draws from a ``torch.Generator``, so its bits are not
``jax.random.bernoulli``'s: its keep rate is tested instead.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.RNN import GRU as JGRU
from apex_tpu.RNN import LSTM as JLSTM
from apex_tpu.RNN import ReLU as JReLU
from apex_tpu.RNN import Tanh as JTanh
from apex_tpu.RNN import mLSTM as JmLSTM
from apex_tpu.RNN import (gru_cell as j_gru_cell, lstm_cell as j_lstm_cell,
                          mlstm_cell as j_mlstm_cell,
                          rnn_relu_cell as j_relu_cell,
                          rnn_tanh_cell as j_tanh_cell)
from apex_tpu.contrib.xentropy import softmax_xentropy_loss as j_xent
from apex_tpu.reparameterization import compute_weights as j_compute_weights

from apex_tpu_torch.RNN import (GRU, LSTM, ReLU, Tanh, gru_cell, lstm_cell,
                                mLSTM, mlstm_cell, rnn_params_from_jax,
                                rnn_relu_cell, rnn_tanh_cell)
from apex_tpu_torch.fp16_utils import FP16_Optimizer
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.train import (rnn_lm_init, rnn_lm_loss,
                                  rnn_lm_train_step)
from apex_tpu_torch.utils.pytree import (path_str, tree_flatten,
                                         tree_leaves_with_path, tree_map,
                                         tree_unflatten)

T, B, I, H = 5, 3, 8, 16
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _scaled(got, ref, tol=OUT_TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(1.0, np.abs(ref))), err.max()


def _peak(got, ref, tol=GRAD_TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    a = np.abs(ref)
    err = np.abs(got - ref)
    assert np.all(err <= tol * np.maximum(a, min(1.0, float(a.max())))), \
        err.max()


def _pair(jmodel, seed):
    """The JAX container's params (numpy) and the port's copy of them."""
    jp = jax.tree_util.tree_map(np.asarray,
                                jmodel.init(jax.random.PRNGKey(seed)))
    return jp, rnn_params_from_jax(jp, device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check_run(jmodel, pmodel, jp, pp, x, hx=None):
    j_out, j_fin = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                                jnp.asarray(x), hx=None if hx is None else
                                [tuple(jnp.asarray(h) for h in hs)
                                 for hs in hx])
    p_out, p_fin = pmodel.apply(pp, torch.from_numpy(x), hx=None if hx is None
                                else [tuple(torch.from_numpy(h) for h in hs)
                                      for hs in hx])
    assert tuple(p_out.shape) == j_out.shape
    _scaled(p_out.numpy(), j_out)
    assert len(p_fin) == len(j_fin)
    for ph, jh in zip(p_fin, j_fin):
        assert len(ph) == len(jh)
        for a, b in zip(ph, jh):
            _scaled(a.numpy(), b)
    return p_out


# name, port cell, JAX cell, port factory, JAX factory, hidden states
CELLS = [("lstm", lstm_cell, j_lstm_cell, LSTM, JLSTM, 2),
         ("gru", gru_cell, j_gru_cell, GRU, JGRU, 1),
         ("relu", rnn_relu_cell, j_relu_cell, ReLU, JReLU, 1),
         ("tanh", rnn_tanh_cell, j_tanh_cell, Tanh, JTanh, 1),
         ("mlstm", mlstm_cell, j_mlstm_cell, mLSTM, JmLSTM, 2)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_each_cell_matches_jax(cell, bias):
    """One step of each cell, and the container's parameter names, shapes
    and ±1/√H initial bounds against the JAX package's."""
    _, pfn, jfn, pmake, jmake, nh = cell
    jmodel, pmodel = jmake(I, H, 1, bias=bias), pmake(I, H, 1, bias=bias)
    jp, pp = _pair(jmodel, 1)
    own = pmodel.init(torch.Generator().manual_seed(1), device="cpu")
    assert {k: tuple(v.shape) for k, v in own["layer0"].items()} == \
        {k: v.shape for k, v in jp["layer0"].items()}
    assert all(float(v.abs().max()) <= H ** -0.5 for v in
               own["layer0"].values())
    x = _x((B, I), 2)
    hidden = tuple(_x((B, H), 3 + i) for i in range(nh))
    got = pfn(torch.from_numpy(x), tuple(torch.from_numpy(h) for h in hidden),
              pp["layer0"])
    ref = jfn(jnp.asarray(x), tuple(jnp.asarray(h) for h in hidden),
              jax.tree_util.tree_map(jnp.asarray, jp["layer0"]))
    assert len(got) == len(ref) == nh
    for a, b in zip(got, ref):
        _scaled(a.numpy(), b)


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_matches_jax(num_layers, bidirectional):
    jmodel = JLSTM(I, H, num_layers, bidirectional=bidirectional)
    pmodel = LSTM(I, H, num_layers, bidirectional=bidirectional)
    jp, pp = _pair(jmodel, 0)
    _check_run(jmodel, pmodel, jp, pp, _x((T, B, I), 0))


def test_gru_matches_jax():
    jp, pp = _pair(JGRU(I, H, 2), 1)
    _check_run(JGRU(I, H, 2), GRU(I, H, 2), jp, pp, _x((T, B, I), 1))


@pytest.mark.parametrize("cls", ["tanh", "relu"])
def test_elman_matches_jax(cls):
    jmodel, pmodel = (JTanh(I, H, 1), Tanh(I, H, 1)) if cls == "tanh" \
        else (JReLU(I, H, 1), ReLU(I, H, 1))
    jp, pp = _pair(jmodel, 2)
    _check_run(jmodel, pmodel, jp, pp, _x((T, B, I), 2))


def test_mlstm_shapes_and_grad():
    """The multiplicative structure's output and every gradient against
    jax.grad of the same loss (2 layers, bidirectional)."""
    jmodel, pmodel = JmLSTM(I, H, 2, bidirectional=True), \
        mLSTM(I, H, 2, bidirectional=True)
    jp, pp = _pair(jmodel, 3)
    assert "w_mih" in pp["layer0"] and "w_mhh" in pp["layer1_rev"]
    x = _x((T, B, I), 3)

    def j_loss(p):
        out, _ = jmodel.apply(p, jnp.asarray(x))
        return jnp.mean(out ** 2)

    jg = jax.grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, jp))
    leaves, treedef = tree_flatten(pp)
    leaves = [p.requires_grad_(True) for p in leaves]
    out, _ = pmodel.apply(tree_unflatten(treedef, leaves), torch.from_numpy(x))
    (out ** 2).mean().backward()
    for (path, leaf), jleaf in zip(tree_leaves_with_path(pp),
                                   jax.tree_util.tree_leaves(jg)):
        assert bool(torch.isfinite(leaf.grad).all()), path_str(path)
        _peak(leaf.grad.numpy(), jleaf)
    assert float(pp["layer0"]["w_mih"].grad.abs().sum()) > 0


def test_batch_first_and_output_size_and_dropout():
    jmodel = JLSTM(I, H, 2, batch_first=True, dropout=0.5, output_size=12)
    pmodel = LSTM(I, H, 2, batch_first=True, dropout=0.5, output_size=12)
    jp, pp = _pair(jmodel, 1)
    assert tuple(pp["layer0"]["w_ho"].shape) == (12, H)
    assert tuple(pmodel.init(torch.Generator().manual_seed(0), device="cpu")
                 ["layer1"]["w_ih"].shape) == (4 * H, 12)
    x = _x((B, T, I), 4)
    # no rng: no dropout, the JAX package's output
    p_out = _check_run(jmodel, pmodel, jp, pp, x)
    assert tuple(p_out.shape) == (B, T, 12)
    o1, _ = pmodel.apply(pp, torch.from_numpy(x))
    assert torch.equal(o1, p_out)
    # with rng: the inter-layer keep rate is 1 - dropout, kept values
    # scaled by 1 / (1 - dropout); a wide layer-1 input shows the rate
    wide = LSTM(4, 512, 2, dropout=0.5)
    wp = wide.init(torch.Generator().manual_seed(5), device="cpu")
    seen = []
    real = wide.cell.fn
    wide.cell = dataclasses.replace(
        wide.cell, fn=lambda xt, hidden, p: (seen.append(xt) or
                                             real(xt, hidden, p)))
    xin = torch.ones(3, 64, 4)
    wide.apply(wp, xin, rng=torch.Generator().manual_seed(7))
    kept = torch.stack(seen[3:])                 # layer 1's inputs
    ref, _ = LSTM(4, 512, 1).apply({"layer0": wp["layer0"]}, xin)
    zero = kept == 0
    assert abs(float(zero.float().mean()) - 0.5) < 0.01
    np.testing.assert_allclose(kept[~zero].numpy(),
                               (ref * 2.0)[~zero].numpy(), rtol=1e-6)
    r1, _ = pmodel.apply(pp, torch.from_numpy(x),
                         rng=torch.Generator().manual_seed(1))
    r2, _ = pmodel.apply(pp, torch.from_numpy(x),
                         rng=torch.Generator().manual_seed(1))
    assert torch.equal(r1, r2) and not torch.equal(r1, p_out)


def test_initial_hidden_passthrough():
    jmodel, pmodel = JGRU(I, H, 1), GRU(I, H, 1)
    jp, pp = _pair(jmodel, 3)
    x = np.zeros((T, B, I), np.float32)
    hx = [(np.ones((B, H), np.float32),)]
    out0 = _check_run(jmodel, pmodel, jp, pp, x)
    out1 = _check_run(jmodel, pmodel, jp, pp, x, hx=hx)
    assert not np.allclose(out0[0].numpy(), out1[0].numpy())
    # an LSTM's (h, c) pairs, one per layer and direction
    jl, pl = JLSTM(I, H, 2, bidirectional=True), LSTM(I, H, 2,
                                                       bidirectional=True)
    jp, pp = _pair(jl, 4)
    hx = [(_x((B, H), 10 + 2 * i), _x((B, H), 11 + 2 * i)) for i in range(4)]
    _check_run(jl, pl, jp, pp, _x((T, B, I), 5), hx=hx)


# -- the byte mLSTM (chip_smoke.py phase 21c at a small width) --------------

def test_byte_model_matches_jax():
    """The byte model's loss and every gradient (g and v included) against
    the same model built from the JAX package's ``RNN``,
    ``reparameterization`` and ``softmax_xentropy_loss``, in fp32, over
    two truncated-BPTT chunks (the second from the first's hidden
    state)."""
    vocab, emb, hidden, t, b = 256, 16, 32, 6, 3
    params, spec, rnn = rnn_lm_init(torch.Generator().manual_seed(0),
                                    vocab=vocab, emb=emb, hidden=hidden,
                                    device="cpu")
    assert spec == {f"rnn/layer0/{n}": 0 for n in
                    ("w_ih", "w_hh", "w_mih", "w_mhh")}
    assert tuple(params["rnn"]["layer0"]["w_hh"]["weight_g"].shape) == \
        (4 * hidden, 1)
    jrnn = JmLSTM(emb, hidden, 1)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()),
                                     params)
    rng = np.random.default_rng(0)
    data = rng.integers(0, vocab, (2 * t + 1, b))

    def j_loss(p, tokens, targets, hx):
        w = j_compute_weights(p, spec)
        out, finals = jrnn.apply(w["rnn"], w["embed"][tokens], hx)
        logits = out.reshape(-1, hidden) @ w["dec"]["w"] + w["dec"]["b"]
        loss = j_xent(logits, targets.reshape(-1), 0.0, -1, True).mean()
        return loss, finals

    hx_j, hx_p = None, None
    for c in range(2):
        tokens, targets = data[c * t:(c + 1) * t], data[c * t + 1:
                                                       (c + 1) * t + 1]
        (jl, jfin), jg = jax.value_and_grad(j_loss, has_aux=True)(
            jparams, jnp.asarray(tokens), jnp.asarray(targets), hx_j)
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        pl, pfin = rnn_lm_loss(
            tree_unflatten(treedef, leaves), spec,
            {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets), "hx": hx_p}, rnn)
        grads = torch.autograd.grad(pl, leaves)
        assert pl.dtype == torch.float32
        _scaled(pl.item(), float(jl))
        for (path, _), g, jleaf in zip(tree_leaves_with_path(params), grads,
                                       jax.tree_util.tree_leaves(jg)):
            _peak(g.numpy(), jleaf)
        hx_j = [tuple(jax.lax.stop_gradient(h) for h in hs) for hs in jfin]
        hx_p = [tuple(h.detach() for h in hs) for hs in pfin]


def test_byte_model_fp16_step_under_fp16_optimizer():
    """The fp16 model under the legacy ``FP16_Optimizer`` (fp32 masters,
    dynamic loss scale): the step updates every master, g's included, the
    model comes back in fp16, the hidden state is carried detached, and a
    few steps on a repeated chunk lower its loss."""
    params, spec, rnn = rnn_lm_init(torch.Generator().manual_seed(1),
                                    vocab=256, emb=16, hidden=32,
                                    device="cpu")
    params = tree_map(lambda p: p.half(), params)
    opt = FP16_Optimizer(FusedAdam(lr=5e-3), params, dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 16})
    rng = np.random.default_rng(1)
    data = torch.from_numpy(rng.integers(0, 256, (7, 4)))
    batch = {"tokens": data[:-1], "targets": data[1:], "hx": None}
    g0 = opt.master_params["rnn"]["layer0"]["w_hh"]["weight_g"].clone()
    losses = []
    for _ in range(4):
        params, loss, hx = rnn_lm_train_step(opt, params, spec, batch,
                                             rnn=rnn)
        losses.append(loss.item())
        assert not opt.overflow
        assert all(not h.requires_grad for hs in hx for h in hs)
    assert params["rnn"]["layer0"]["w_hh"]["weight_v"].dtype == torch.float16
    assert not torch.equal(
        opt.master_params["rnn"]["layer0"]["w_hh"]["weight_g"], g0)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert opt.loss_scale == 2.0 ** 16
