"""Model configuration and the registry behind ``get_config(arch)``.

The port's own copy of ``ModelConfig``, ``register`` and ``get_config``
from the JAX package's ``repro/configs/base.py``, with the same fields and
defaults so one config describes the same model on both sides. The dtype
fields are names (``"float32"``, ``"bfloat16"``) that
:func:`torch_dtype` turns into torch dtypes. The port serves the dense
family only; the ``moe`` and ``mamba`` sub-configs of the other families
keep their fields here (always ``None`` for a dense model) and the models
that need them raise ``NotImplementedError`` (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    tied_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    moe: Optional[Any] = None
    mamba: Optional[Any] = None
    # hybrid (jamba): attention layer each `attn_period` layers at offset
    attn_period: int = 0
    attn_offset: int = 0
    # encdec
    n_encoder_layers: int = 0
    # frontends (vlm/audio): inputs arrive as precomputed embeddings
    frontend_positions: int = 0
    act: str = "silu"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count of a dense model (the only family the
        port builds)."""
        if self.family != "dense" or self.moe is not None:
            raise NotImplementedError(
                f"param_count: the port builds the dense family only, not "
                f"{self.family!r} (ROADMAP.md, queue A)")
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tied_embeddings else 2)
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        ffn = (3 if self.act == "silu" else 2) * d * self.d_ff
        return emb + self.n_layers * (attn + ffn + 2 * d)


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (and so on)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        mod = arch.replace("-", "_").replace(".", "_")
        try:
            importlib.import_module(f"repro_torch.configs.{mod}")
        except ModuleNotFoundError:
            raise KeyError(
                f"unknown arch {arch!r}: the port has qwen2-0.5b only; the "
                "other configs come with their families (ROADMAP.md, "
                "queue A)") from None
    return _REGISTRY[arch]
