"""The yardstick's arithmetic, frozen here so that no later change to the
program moves it: the card's peaks, the roofline bound, the model FLOP
counts of each cell and the operation and byte counts of each kernel.

Each copy names the file and line it was taken from.  Nothing here reads
the program."""
from __future__ import annotations

# Copied from apex_tpu_torch/pyprof/prof.py:56 (the ``h100`` ceilings row:
# NVIDIA's H100 SXM5 data sheet, dense, no sparsity) and chip_smoke.py:413-415
# (the fp32 and TF32 rows beside it).
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TF32_PEAK_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the longer of the bytes at HBM
    bandwidth and the operations at the dtype's peak.  Copied from
    chip_smoke.py:614-617 (``bound``), in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# --- kernel counts, one launch at the cell's shapes --------------------------

def flash_fwd_counts(bh: int, sq: int, sk: int, d: int, dtype: str,
                     bias_elems: int, causal: bool = False):
    """(bytes, flops) of one forward: q, k, v read, out written, the fp32
    bias read and the fp32 lse written once; two products over the
    visible (query, key) pairs.  Copied from chip_smoke.py:1115-1121."""
    es = _BYTES[dtype]
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * es + bias_elems * 4 \
        + bh * sq * 4
    return nbytes, 4.0 * d * _pairs(sq, sk, causal) * bh


def flash_bwd_counts(bh: int, sq: int, sk: int, d: int, dtype: str,
                     bias_elems: int, causal: bool = False):
    """(bytes, flops) of one fused recompute backward: q, k, v, out, dO
    read and dq, dk, dv written, two fp32 row statistics, the bias; five
    products (s, dP, dV, dQ, dK).  Copied from chip_smoke.py:1384-1388."""
    es = _BYTES[dtype]
    nbytes = 7 * bh * sq * d * es + 2 * bh * sq * 4 + bias_elems * 4
    return nbytes, 10.0 * d * _pairs(sq, sk, causal) * bh


def flash_bwd_dq_counts(bh: int, s: int, d: int, dtype: str,
                        bias_elems: int):
    """(bytes, flops) of the split route's dq kernel.  Copied from
    chip_smoke.py:1591-1605."""
    es = _BYTES[dtype]
    io = 4 * bh * s * d * es + 2 * bh * s * 4 + bias_elems * 4
    return io + bh * s * d * es, 6.0 * d * bh * s * s


def flash_bwd_dkv_counts(bh: int, s: int, d: int, dtype: str,
                         bias_elems: int):
    """(bytes, flops) of the split route's dk / dv kernel.  Copied from
    chip_smoke.py:1591-1609."""
    es = _BYTES[dtype]
    io = 4 * bh * s * d * es + 2 * bh * s * 4 + bias_elems * 4
    return io + 2 * bh * s * d * es, 8.0 * d * bh * s * s


def ln_fwd_counts(n: int, h: int, dtype: str):
    """(bytes, flops) of one layer-norm forward over n rows of h: x read,
    y written, γ and β read, the fp32 mean and inverse deviation written.
    Copied from chip_smoke.py:1780-1781."""
    es = _BYTES[dtype]
    return 2 * n * h * es + 2 * n * 4 + 2 * h * es, 8.0 * n * h


def ln_bwd_counts(n: int, h: int, dtype: str):
    """(bytes, flops) of one layer-norm backward (dx): dy and x read, dx
    written, γ and the two row statistics read.  Copied from
    chip_smoke.py:1782-1783."""
    es = _BYTES[dtype]
    return 3 * n * h * es + 2 * n * 4 + h * es, 12.0 * n * h


def _pairs(sq: int, sk: int, causal: bool) -> int:
    return sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk


#: the flops-bound dtype each kernel's bound takes (chip_smoke.py: the
#: layer norm's bound is "float32", its arithmetic's type)
KERNEL_BOUND_DTYPE = {"ln_fwd": "float32", "ln_bwd": "float32"}


# --- model FLOPs of a step ---------------------------------------------------

def bert_step_flops(layers: int, d: int, ff: int, vocab: int, batch: int,
                    seq: int, predicted: int) -> float:
    """Model FLOPs of one training step of a BERT encoder: 6 x the
    parameters of the layers' products x tokens, 6 x the tied head's
    product at the predicted positions only, and 12 L B S^2 D for the two
    attention products forward and backward.  No recompute is counted."""
    tokens = batch * seq
    return (6.0 * layers * (4 * d * d + 2 * d * ff) * tokens
            + 6.0 * d * vocab * predicted
            + 12.0 * layers * batch * seq * seq * d)


def resnet_flops(stage_sizes, width: int, num_classes: int, hw: int,
                 bottleneck: bool = True) -> float:
    """Forward FLOPs of one image: 2 x the multiply-adds of every
    convolution ("SAME" output sizes) and of the fc layer.  Copied from
    chip_smoke.py:3628-3657 (``resnet_flops``)."""
    def conv(size, k, cin, cout, stride):
        out = -(-size // stride)
        return out, 2.0 * out * out * k * k * cin * cout

    expansion = 4 if bottleneck else 1
    size, flops = conv(hw, 7, 3, width, 2)
    size = -(-size // 2)                                # the max-pool
    cin = width
    for si, n_blocks in enumerate(stage_sizes):
        cmid = width * 2 ** si
        cout = cmid * expansion
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            if bottleneck:
                _, f1 = conv(size, 1, cin, cmid, 1)
                out, f2 = conv(size, 3, cmid, cmid, stride)
                _, f3 = conv(out, 1, cmid, cout, 1)
                flops += f1 + f2 + f3
            else:
                out, f1 = conv(size, 3, cin, cmid, stride)
                _, f2 = conv(out, 3, cmid, cout, 1)
                flops += f1 + f2
            if stride != 1 or cin != cout:
                flops += conv(size, 1, cin, cout, stride)[1]
            size, cin = out, cout
    return flops + 2.0 * cin * num_classes


def masked_positions(seq: int, masked_lm_prob: float,
                     max_predictions: int) -> int:
    """Predictions a sequence: BERT's ``create_pretraining_data.py``
    rounding, ``min(max_predictions_per_seq, max(1, round(len *
    masked_lm_prob)))`` over the tokens that may be masked."""
    return min(max_predictions, max(1, int(round(seq * masked_lm_prob))))
