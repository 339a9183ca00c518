"""repro_torch.configs — model configurations (port of the JAX package's
``repro/configs``): :class:`~repro_torch.configs.base.ModelConfig` with its
:class:`~repro_torch.configs.base.MoEConfig` and
:class:`~repro_torch.configs.base.MambaConfig`, the registry behind
:func:`get_config`, and the configs of every family:
``qwen2-0.5b``, ``granite-3-2b``, ``granite-34b`` and ``qwen1.5-32b``
(dense), ``internvl2-1b`` (vlm), ``granite-moe-1b-a400m`` and
``arctic-480b`` (moe), ``falcon-mamba-7b`` (ssm), ``jamba-v0.1-52b``
(hybrid) and ``seamless-m4t-large-v2`` (encdec); the dry run's
:data:`~repro_torch.configs.base.SHAPES` and
:func:`~repro_torch.configs.base.cell_supported`."""
from .base import (ARCH_IDS, SHAPES, MambaConfig, ModelConfig, MoEConfig,
                   ShapeConfig, cell_supported, get_config, register,
                   registered)

__all__ = ["ARCH_IDS", "SHAPES", "MambaConfig", "ModelConfig", "MoEConfig",
           "ShapeConfig", "cell_supported", "get_config", "register",
           "registered"]
