"""The spans inside the port's training step (``telemetry.trace.STEP_SPANS``).

One ``train.train_step`` of a tiny BERT under amp O5 with FusedLAMB on the
flat engine, under ``torch.profiler`` on the CPU: every name of
``STEP_SPANS`` appears as a ``user_annotation`` row, each nested in the
span the table of the tuple's module gives (the ``model.*`` spans in
``train.forward``, the ``attention.*`` ones in ``model.attention``, the
other ``amp.*`` ones in ``amp.step``), ``model.attention`` and
``model.mlp`` once a layer, ``model.embed`` twice (the rows and the
stacked leaves' unbind).  Under remat each layer's spans open again
inside ``train.backward``, where the recompute runs.  With no profiler
session the same steps make no ``record_function`` of a step span.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from apex_tpu_torch import amp
from apex_tpu_torch.models.transformer import (TransformerConfig,
                                               transformer_init)
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.telemetry.trace import STEP_SPANS
from apex_tpu_torch.train import train_step

LAYERS = 2
PARENT = {
    "train.forward": None, "train.backward": None, "amp.step": None,
    "model.embed": "train.forward", "model.attention": "train.forward",
    "model.mlp": "train.forward", "model.head": "train.forward",
    "model.loss": "train.forward",
    "attention.qkv": "model.attention", "attention.core": "model.attention",
    "attention.out": "model.attention",
    "amp.unscale": "amp.step", "amp.flatten": "amp.step",
    "amp.optimizer": "amp.step", "amp.select": "amp.step",
    "amp.model_copy": "amp.step",
}


def _step(remat):
    cfg = TransformerConfig(vocab_size=64, max_len=16, num_layers=LAYERS,
                            d_model=32, num_heads=2, d_ff=64,
                            dtype=torch.bfloat16, attn_impl="fast",
                            xent_impl="pallas", remat=remat)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    state = amp.initialize(params, FusedLAMB(lr=1e-3, impl="fused"),
                           opt_level="O5", verbosity=0)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 64, (2, 16), generator=gen),
             "targets": torch.randint(0, 64, (2, 16), generator=gen),
             "weights": torch.ones(2, 16)}
    return lambda st: train_step(st, batch, cfg)[0], state


def _rows(prof):
    """(name, start, end) of every step span, in time order."""
    rows = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name in STEP_SPANS]
    return sorted(rows, key=lambda r: (r[1], -r[2]))


def _parents(rows):
    """Each row's innermost enclosing row's name (None at the top)."""
    out, stack = [], []
    for name, t0, t1 in rows:
        while stack and stack[-1][2] <= t0:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, t0, t1))
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_o5_step_opens_every_step_span_nested_as_the_table(remat):
    step, state = _step(remat)
    state = step(state)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state)
    rows = _rows(prof)
    names = [r[0] for r in rows]
    assert set(names) == set(STEP_SPANS) == set(PARENT)
    recompute = 2 if remat else 1
    assert names.count("model.attention") == LAYERS * recompute
    assert names.count("model.mlp") == LAYERS * recompute
    assert names.count("attention.core") == LAYERS * recompute
    assert names.count("model.embed") == 2
    for name in ("train.forward", "train.backward", "amp.step"):
        assert names.count(name) == 1
    top = [r for r in rows if PARENT[r[0]] is None]
    assert [r[0] for r in top] == ["train.forward", "train.backward",
                                   "amp.step"]
    for name, parent in _parents(rows):
        if remat and parent == "train.backward":
            # the recompute: a layer's spans reopened in the backward
            assert name in ("model.attention", "model.mlp"), name
        else:
            assert parent == PARENT[name], (name, parent)


def test_no_profiler_session_makes_no_range(monkeypatch):
    """The spans make a ``record_function`` only while a session records."""
    from torch.autograd import profiler
    made = []

    class Spy(profiler.record_function):
        def __init__(self, name, *args, **kwargs):
            made.append(name)
            super().__init__(name, *args, **kwargs)
    monkeypatch.setattr(profiler, "record_function", Spy)
    step, state = _step(False)
    state = step(step(state))
    assert [n for n in made if n in STEP_SPANS] == []
    with profile(activities=[ProfilerActivity.CPU]):
        step(state)
    assert set(made) >= set(STEP_SPANS)
