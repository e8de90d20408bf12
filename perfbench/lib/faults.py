"""Faults planted underneath a run's timed path.  Each replaces an entry
of ``apex_tpu_torch`` for the length of a ``with`` block; the drivers look
their entry up at every call."""
from __future__ import annotations

import contextlib

#: a step that returns its state unchanged; half of the batch left out
#: (the mean taken over the rest); the answer altered where it is made
FAULTS = ("unchanged", "half_batch", "altered")
#: the altered answer: the step's loss 5 % off.  ResNet-50's bf16 program
#: reads first-step loss gaps up to 0.2 % on its own, so a 2 % error read
#: under ten times that (PERF.md)
ALTER = 1.05


def _half(x):
    return x[: x.shape[0] // 2]


@contextlib.contextmanager
def planted(name: str):
    from apex_tpu_torch import amp, train
    saved = (amp.amp_step, train.train_step, train.resnet_train_step)
    plain_step, plain_rn = saved[1], saved[2]
    if name == "unchanged":
        amp.amp_step = lambda state, grads, **kw: state
    elif name == "half_batch":
        train.train_step = lambda st, batch, cfg, **kw: plain_step(
            st, {k: _half(v) for k, v in batch.items()}, cfg, **kw)
        train.resnet_train_step = lambda st, bn, x, y, cfg, **kw: plain_rn(
            st, bn, _half(x), _half(y), cfg, **kw)
    elif name == "altered":
        def bert(*a, **kw):
            st, loss = plain_step(*a, **kw)
            return st, loss * ALTER

        def rn(*a, **kw):
            st, bn, loss, acc = plain_rn(*a, **kw)
            return st, bn, loss * ALTER, acc
        train.train_step, train.resnet_train_step = bert, rn
    else:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")
    try:
        yield
    finally:
        amp.amp_step, train.train_step, train.resnet_train_step = saved
