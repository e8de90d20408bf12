from .transformer import (TransformerConfig, bert_large_config,  # noqa: F401
                          params_from_jax, tp_gather_params, tp_shard_params,
                          transformer_apply, transformer_init,
                          transformer_loss, transformer_pspecs)
from .resnet import (ResNetConfig, resnet18_config,  # noqa: F401
                     resnet50_config, resnet_apply, resnet_init,
                     resnet_params_from_jax)
from .dcgan import (DCGANConfig, dcgan_init,  # noqa: F401
                    dcgan_params_from_jax, discriminator_apply,
                    generator_apply)
from .moe_transformer import (MoETransformerConfig,  # noqa: F401
                              moe_params_from_jax, moe_transformer_apply,
                              moe_transformer_init, moe_transformer_loss)
