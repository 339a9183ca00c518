"""Model configuration and the registry behind ``get_config(arch)``.

The port's own copy of ``MambaConfig``, ``ModelConfig``, ``register`` and
``get_config`` from the JAX package's ``repro/configs/base.py``, with the
same fields and defaults so one config describes the same model on both
sides. The dtype fields are names (``"float32"``, ``"bfloat16"``) that
:func:`torch_dtype` turns into torch dtypes. The port serves the dense and
ssm families; the ``moe`` sub-config of the other families keeps its field
here (always ``None`` for the families the port builds) and the models
that need it raise ``NotImplementedError`` (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default ceil(d_model/16)

    def rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


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
    mamba: Optional[MambaConfig] = None
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
        """Analytic parameter count of a dense or ssm model (the families
        the port builds), as the JAX package counts it."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tied_embeddings else 2)
        if self.family == "ssm":
            m = self.mamba
            di = m.expand * d
            per = (d * 2 * di                            # in_proj
                   + m.d_conv * di + di                  # conv + bias
                   + di * (m.rank(d) + 2 * m.d_state)    # x_proj
                   + m.rank(d) * di + di                 # dt_proj + bias
                   + di * m.d_state + di                 # A_log, D
                   + di * d                              # out_proj
                   + d)                                  # norm
            return emb + self.n_layers * per
        if self.family != "dense" or self.moe is not None:
            raise NotImplementedError(
                f"param_count: the port builds the dense and ssm families "
                f"only, not {self.family!r} (ROADMAP.md, queue A)")
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
                f"unknown arch {arch!r}: the port has qwen2-0.5b and "
                "falcon-mamba-7b; the other configs come with their families "
                "(ROADMAP.md, queue A)") from None
    return _REGISTRY[arch]
