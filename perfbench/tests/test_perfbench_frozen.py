"""Every frozen count against a value worked out by hand."""
import pytest

from perfbench.lib import frozen


def test_bert_large_step_flops_by_hand():
    # layers: 6 x 24 x (4 x 1024^2 + 2 x 1024 x 4096) x 32,768 tokens
    layers = 6 * 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096) * 32768
    assert layers == 59_373_627_899_904
    head = 6 * 1024 * 30592 * (64 * 77)          # predicted positions only
    assert head == 926_253_318_144
    attn = 12 * 24 * 64 * 512 ** 2 * 1024
    assert attn == 4_947_802_324_992
    got = frozen.bert_step_flops(24, 1024, 4096, 30592, 64, 512, 64 * 77)
    assert got == layers + head + attn
    assert round(got / 1e12, 1) == 65.2           # the issue's 65.3 TFLOP


def test_resnet50_flops_by_hand():
    # one bottleneck stage of one block, width 4, on an 8x8 image, 10
    # classes: conv 7x7/2 -> 4x4, pool -> 2x2, 1x1 4->4, 3x3 4->4,
    # 1x1 4->16, projection 1x1 4->16, fc 16->10
    f = frozen.resnet_flops([1], 4, 10, 8)
    by_hand = (2 * 4 * 4 * 49 * 3 * 4 + 2 * 2 * 2 * 1 * 4 * 4
               + 2 * 2 * 2 * 9 * 4 * 4 + 2 * 2 * 2 * 1 * 4 * 16
               + 2 * 2 * 2 * 1 * 4 * 16 + 2 * 16 * 10)
    assert f == by_hand
    r50 = frozen.resnet_flops([3, 4, 6, 3], 64, 1000, 224)
    assert 8.17e9 < r50 < 8.23e9                  # 4.1 G multiply-adds
    assert round(3 * r50 * 256 / 1e12, 1) == 6.3  # the issue's 6.3 TFLOP


def test_flash_counts_by_hand():
    bh, s, d = 64 * 16, 512, 64
    nbytes, flops = frozen.flash_fwd_counts(bh, s, s, d, "bfloat16", s)
    assert nbytes == 4 * bh * s * d * 2 + s * 4 + bh * s * 4 == 270_534_656
    assert flops == 4 * d * s * s * bh == 68_719_476_736
    nbytes, flops = frozen.flash_bwd_counts(bh, s, s, d, "bfloat16", s)
    assert nbytes == 7 * bh * s * d * 2 + 2 * bh * s * 4 + s * 4
    assert flops == 10 * d * s * s * bh
    nbytes, flops = frozen.flash_bwd_dq_counts(bh, s, d, "bfloat16", s)
    assert (nbytes, flops) == (5 * bh * s * d * 2 + 2 * bh * s * 4 + s * 4,
                               6 * d * bh * s * s)
    nbytes, flops = frozen.flash_bwd_dkv_counts(bh, s, d, "bfloat16", s)
    assert (nbytes, flops) == (6 * bh * s * d * 2 + 2 * bh * s * 4 + s * 4,
                               8 * d * bh * s * s)
    _, causal = frozen.flash_fwd_counts(1, 4, 4, 2, "float32", 4, True)
    assert causal == 4 * 2 * (1 + 2 + 3 + 4)


def test_layer_norm_counts_by_hand():
    n, h = 32768, 1024
    assert frozen.ln_fwd_counts(n, h, "bfloat16") == (
        2 * n * h * 2 + 2 * n * 4 + 2 * h * 2, 8.0 * n * h)
    assert frozen.ln_fwd_counts(n, h, "bfloat16")[0] == 134_483_968
    assert frozen.ln_bwd_counts(n, h, "bfloat16") == (
        3 * n * h * 2 + 2 * n * 4 + h * 2, 12.0 * n * h)


def test_bound_takes_the_longer_side():
    # 3.35 TB of bytes take 1 s; 989 T bf16 operations take 1 s
    assert frozen.bound_s(3.35e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert frozen.bound_s(1.0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert frozen.bound_s(1.0, 67e12, "float32") == pytest.approx(1.0)


@pytest.mark.parametrize("seq,prob,cap,want", [(512, 0.15, 80, 77),
                                               (128, 0.15, 20, 19),
                                               (4, 0.15, 20, 1)])
def test_masked_positions_round_as_bert(seq, prob, cap, want):
    assert frozen.masked_positions(seq, prob, cap) == want
