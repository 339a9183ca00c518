"""repro_torch.configs — model configurations (port of the JAX package's
``repro/configs``): :class:`~repro_torch.configs.base.ModelConfig` and
:class:`~repro_torch.configs.base.MambaConfig`, the registry behind
:func:`get_config`, and the configs the port serves so far,
``qwen2-0.5b`` (dense) and ``falcon-mamba-7b`` (ssm)."""
from .base import MambaConfig, ModelConfig, get_config, register

__all__ = ["MambaConfig", "ModelConfig", "get_config", "register"]
