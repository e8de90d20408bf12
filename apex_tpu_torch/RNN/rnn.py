"""RNN toolkit: counterpart of ``apex_tpu/RNN/rnn.py`` (the reference's
``apex/RNN``).

Cells are plain functions of ``(x, hidden, p)`` over a dict of tensors; the
time loop is a Python loop over T carrying the hidden tuple (the JAX
package's ``lax.scan``: PyTorch runs eagerly, so there is nothing to
compile), layers and directions are Python loops, and a reverse direction
walks T backwards.

API as the JAX package's (``models.py:19-54`` of the reference):
``LSTM / GRU / ReLU / Tanh / mLSTM(input_size, hidden_size, num_layers,
bias=True, batch_first=False, dropout=0, bidirectional=False,
output_size=None)`` return an :class:`RNNContainer` with ``init(gen,
device=None) -> params`` and ``apply(params, x, hx=None, *, rng=None) ->
(output, final_hidden)``.  Parameter names and gate layouts are torch's
(i, f, g, o for the LSTMs; r, z, n for the GRU), and the initialisation is
uniform in ±1/√H, drawn on the CPU from ``gen``.
:func:`rnn_params_from_jax` takes the JAX package's parameters.

Two differences, both documented: inter-layer dropout draws its keep mask
from a ``torch.Generator`` (``rng``), so its bits are not
``jax.random.bernoulli``'s (the keep rate is the same); and the zero
initial hidden state takes ``x``'s dtype, where the JAX package's is fp32
and its mixed products promote, since a torch product refuses mixed
dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from ..utils.device import from_numpy, resolve_device

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "RNNContainer",
           "lstm_cell", "gru_cell", "rnn_relu_cell", "rnn_tanh_cell",
           "mlstm_cell", "rnn_params_from_jax"]


# --------------------------------------------------------------------------
# cells (torch.nn's cell math, summed in the JAX package's order)
# --------------------------------------------------------------------------

def rnn_tanh_cell(x, hidden, p):
    (h,) = hidden
    return (torch.tanh(x @ p["w_ih"].t() + h @ p["w_hh"].t()
                       + p.get("b_ih", 0) + p.get("b_hh", 0)),)


def rnn_relu_cell(x, hidden, p):
    (h,) = hidden
    return (torch.relu(x @ p["w_ih"].t() + h @ p["w_hh"].t()
                       + p.get("b_ih", 0) + p.get("b_hh", 0)),)


def _lstm_tail(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return torch.tanh(c_new) * o, c_new


def lstm_cell(x, hidden, p):
    h, c = hidden
    return _lstm_tail(x @ p["w_ih"].t() + h @ p["w_hh"].t()
                      + p.get("b_ih", 0) + p.get("b_hh", 0), c)


def gru_cell(x, hidden, p):
    (h,) = hidden
    ir, iz, in_ = (x @ p["w_ih"].t() + p.get("b_ih", 0)).chunk(3, dim=-1)
    hr, hz, hn = (h @ p["w_hh"].t() + p.get("b_hh", 0)).chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return ((1.0 - z) * n + z * h,)


def mlstm_cell(x, hidden, p):
    """Multiplicative LSTM (the reference's ``cells.py:55-83``): the hidden
    entering the gates is modulated by ``m = (W_mih x) * (W_mhh h)``."""
    h, c = hidden
    m = (x @ p["w_mih"].t()) * (h @ p["w_mhh"].t())
    return _lstm_tail(x @ p["w_ih"].t() + p.get("b_ih", 0)
                      + m @ p["w_hh"].t() + p.get("b_hh", 0), c)


@dataclasses.dataclass(frozen=True)
class _CellSpec:
    fn: Callable
    gate_multiplier: int
    n_hidden_states: int
    multiplicative: bool = False


_CELLS = {
    "lstm": _CellSpec(lstm_cell, 4, 2),
    "gru": _CellSpec(gru_cell, 3, 1),
    "relu": _CellSpec(rnn_relu_cell, 1, 1),
    "tanh": _CellSpec(rnn_tanh_cell, 1, 1),
    "mlstm": _CellSpec(mlstm_cell, 4, 2, multiplicative=True),
}


# --------------------------------------------------------------------------
# the container (the reference's stackedRNN / bidirectionalRNN)
# --------------------------------------------------------------------------

class RNNContainer:
    """A stacked, optionally bidirectional RNN over one cell kind.  Layer
    ``l``'s parameters are ``params[f"layer{l}"]`` (``"layer{l}_rev"`` for
    the reverse direction), with ``w_ho`` (output_size, H) where
    ``output_size`` differs from ``hidden_size``."""

    def __init__(self, cell: str, input_size: int, hidden_size: int,
                 num_layers: int, bias=True, batch_first=False, dropout=0.0,
                 bidirectional=False, output_size: Optional[int] = None):
        if cell not in _CELLS:
            raise ValueError(f"unknown cell {cell!r}; have {sorted(_CELLS)}")
        self.cell = _CELLS[cell]
        self.cell_name = cell
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bias = bias
        self.batch_first = batch_first
        self.dropout = float(dropout)
        self.bidirectional = bidirectional
        self.output_size = output_size if output_size is not None \
            else hidden_size
        self.proj = output_size is not None and output_size != hidden_size
        self.num_directions = 2 if bidirectional else 1

    # -- params --------------------------------------------------------------

    def _uniform(self, gen, shape, dev):
        std = 1.0 / math.sqrt(self.hidden_size)   # torch RNN reset_parameters
        return (torch.rand(shape, generator=gen) * (2 * std) - std).to(dev)

    def _layer_params(self, gen, in_size, dev):
        gm, h = self.cell.gate_multiplier, self.hidden_size
        p = {"w_ih": self._uniform(gen, (gm * h, in_size), dev),
             "w_hh": self._uniform(gen, (gm * h, h), dev)}
        if self.bias:
            p["b_ih"] = self._uniform(gen, (gm * h,), dev)
            p["b_hh"] = self._uniform(gen, (gm * h,), dev)
        if self.cell.multiplicative:
            p["w_mih"] = self._uniform(gen, (h, in_size), dev)
            p["w_mhh"] = self._uniform(gen, (h, h), dev)
        return p

    def init(self, gen: torch.Generator, device=None) -> dict:
        """fp32 parameters drawn on the CPU from ``gen`` (a seed gives the
        same weights on every device), on ``device`` (default
        ``"cuda"``)."""
        dev = resolve_device(device)
        params = {}
        out_of_layer = self.output_size * self.num_directions
        for layer in range(self.num_layers):
            in_size = self.input_size if layer == 0 else out_of_layer
            for d in range(self.num_directions):
                name = f"layer{layer}" + ("_rev" if d else "")
                params[name] = self._layer_params(gen, in_size, dev)
                if self.proj:
                    params[name]["w_ho"] = self._uniform(
                        gen, (self.output_size, self.hidden_size), dev)
        return params

    # -- forward -------------------------------------------------------------

    def _zero_hidden(self, x):
        return tuple(x.new_zeros((x.shape[1], self.hidden_size))
                     for _ in range(self.cell.n_hidden_states))

    def _run_direction(self, p, x, h0, reverse):
        """x (T, B, F) -> (T, B, out), the final hidden tuple."""
        hidden = tuple(h0)
        outs = [None] * x.shape[0]
        steps = range(x.shape[0] - 1, -1, -1) if reverse \
            else range(x.shape[0])
        for t in steps:
            hidden = tuple(self.cell.fn(x[t], hidden, p))
            out = hidden[0]
            outs[t] = out @ p["w_ho"].t() if self.proj else out
        return torch.stack(outs), hidden

    def apply(self, params, x, hx=None, *, rng=None):
        """x (T, B, input), or (B, T, input) with ``batch_first``.  Returns
        (output (T|B, B|T, out * directions), the final hidden tuple of
        each layer and direction, in order).  ``hx``: the initial hidden
        tuples in that order (zeros where None).  ``rng`` (a
        ``torch.Generator``) turns on the inter-layer dropout."""
        if self.batch_first:
            x = x.transpose(0, 1)
        finals = []
        out = x
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.num_directions):
                name = f"layer{layer}" + ("_rev" if d else "")
                h0 = hx[len(finals)] if hx is not None \
                    else self._zero_hidden(out)
                ys, h_t = self._run_direction(params[name], out, h0,
                                              reverse=bool(d))
                outs.append(ys)
                finals.append(h_t)
            out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
            if (self.dropout > 0 and rng is not None
                    and layer < self.num_layers - 1):
                keep = torch.rand(out.shape, generator=rng,
                                  device=rng.device) >= self.dropout
                out = out * keep.to(out.device, out.dtype) \
                    / (1.0 - self.dropout)
        if self.batch_first:
            out = out.transpose(0, 1)
        return out, finals

    __call__ = apply


def _model(cell):
    def make(input_size, hidden_size, num_layers, bias=True,
             batch_first=False, dropout=0, bidirectional=False,
             output_size=None):
        return RNNContainer(cell, input_size, hidden_size, num_layers,
                            bias=bias, batch_first=batch_first,
                            dropout=dropout, bidirectional=bidirectional,
                            output_size=output_size)
    make.__name__ = cell.upper()
    make.__doc__ = (f"apex.RNN.models.{make.__name__} analog "
                    "(models.py:19-54); returns an RNNContainer.")
    return make


LSTM = _model("lstm")
GRU = _model("gru")
ReLU = _model("relu")
Tanh = _model("tanh")
mLSTM = _model("mlstm")


def rnn_params_from_jax(params, device=None) -> Dict[str, Dict[str,
                                                              torch.Tensor]]:
    """The JAX package's RNN parameters (``{"layer0": {"w_ih": ...}, ...}``
    as numpy arrays, or anything ``np.asarray`` takes) as the port's, same
    names, layout and values, on ``device`` (default ``"cuda"``)."""
    return from_numpy(params, device)
