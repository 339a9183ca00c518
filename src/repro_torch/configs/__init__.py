"""repro_torch.configs — model configurations (port of the JAX package's
``repro/configs``): :class:`~repro_torch.configs.base.ModelConfig` with its
:class:`~repro_torch.configs.base.MoEConfig` and
:class:`~repro_torch.configs.base.MambaConfig`, the registry behind
:func:`get_config`, and the configs of the families the port builds:
``qwen2-0.5b``, ``granite-3-2b``, ``granite-34b`` and ``qwen1.5-32b``
(dense), ``internvl2-1b`` (vlm), ``granite-moe-1b-a400m`` and
``arctic-480b`` (moe) and ``falcon-mamba-7b`` (ssm)."""
from .base import (MambaConfig, ModelConfig, MoEConfig, get_config, register,
                   registered)

__all__ = ["MambaConfig", "ModelConfig", "MoEConfig", "get_config",
           "register", "registered"]
