"""The port's transformer forward against the JAX package's.

One JAX parameter pytree (from ``apex_tpu.models.transformer_init``) is
carried across with ``params_from_jax``; the same numpy tokens and mask go
through both ``transformer_apply``s.  fp32 logits agree to 1e-4 (two
layers of fp32 matmuls summed in different orders).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer_apply as jax_apply
from apex_tpu.models import transformer_init as jax_init

from apex_tpu_torch.models import (TransformerConfig, bert_large_config,
                                   params_from_jax, transformer_apply,
                                   transformer_init)

DIMS = dict(vocab_size=97, max_len=48, num_layers=2, d_model=64,
            num_heads=4, d_ff=128)
B, S = 2, 40


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(jax.random.PRNGKey(3), JaxConfig(**DIMS))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("attn_impl", ["default", "fast"])
def test_apply_matches_jax(jax_params, attn_impl, causal, masked):
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, DIMS["vocab_size"], (B, S)).astype(np.int32)
    mask = None
    if masked:                         # nonzero = PAD, trailing pads
        mask = np.zeros((B, S), np.int32)
        mask[0, 30:] = 1
        mask[1, 35:] = 1
    jcfg = JaxConfig(**DIMS, causal=causal, attn_impl=attn_impl)
    ref = jax_apply(jax_params, jnp.asarray(tokens), jcfg,
                    mask=None if mask is None else jnp.asarray(mask))
    pcfg = TransformerConfig(**DIMS, causal=causal, attn_impl=attn_impl)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             device="cpu")
    out = transformer_apply(params, torch.from_numpy(tokens).long(), pcfg,
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    assert out.shape == (B, S, DIMS["vocab_size"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_params_from_jax_keeps_structure_and_layout(jax_params):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             device="cpu")
    for group, leaves in jax_params.items():
        assert set(params[group]) == set(leaves)
        for name, leaf in leaves.items():
            assert tuple(params[group][name].shape) == leaf.shape
            np.testing.assert_array_equal(params[group][name].numpy(),
                                          np.asarray(leaf))
    D = DIMS["d_model"]
    assert tuple(params["layers"]["wqkv"].shape) == (2, D, 3 * D)


def test_init_is_seeded_and_shaped():
    cfg = TransformerConfig(**DIMS)
    a = transformer_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = transformer_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ja = jax_init(jax.random.PRNGKey(0), JaxConfig(**DIMS))
    for group, leaves in ja.items():
        for name, leaf in leaves.items():
            assert tuple(a[group][name].shape) == leaf.shape
            torch.testing.assert_close(a[group][name], b[group][name],
                                       rtol=0, atol=0)
    untied = transformer_init(dataclasses.replace(cfg, tie_embeddings=False),
                              torch.Generator().manual_seed(0), device="cpu")
    assert tuple(untied["head"]["out"].shape) == (DIMS["d_model"],
                                                   DIMS["vocab_size"])


def test_bert_large_widths_match_jax():
    from apex_tpu.models.transformer import bert_large_config as jax_bert
    j = jax_bert(attn_impl="fast", causal=True)
    p = bert_large_config(attn_impl="fast", causal=True)
    for f in ("vocab_size", "max_len", "num_layers", "d_model", "num_heads",
              "d_ff", "causal", "attn_impl", "tie_embeddings"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.head_dim == 64


def test_unknown_attn_impl_raises(jax_params):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        transformer_apply(params, torch.zeros(1, 4, dtype=torch.long),
                          TransformerConfig(**DIMS, attn_impl="ring"))
