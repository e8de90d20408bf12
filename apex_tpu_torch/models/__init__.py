from .transformer import (TransformerConfig, bert_large_config,  # noqa: F401
                          params_from_jax, transformer_apply,
                          transformer_init, transformer_loss)
