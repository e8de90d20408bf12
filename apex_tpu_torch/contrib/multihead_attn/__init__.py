from .flash import flash_attention  # noqa: F401
