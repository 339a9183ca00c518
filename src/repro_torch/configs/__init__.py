"""repro_torch.configs — model configurations (port of the JAX package's
``repro/configs``): :class:`~repro_torch.configs.base.ModelConfig`, the
registry behind :func:`get_config`, and the one registered config the port
serves so far, ``qwen2-0.5b``."""
from .base import ModelConfig, get_config, register

__all__ = ["ModelConfig", "get_config", "register"]
