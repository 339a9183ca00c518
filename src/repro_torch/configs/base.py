"""Model configuration and the registry behind ``get_config(arch)``.

The port's own copy of ``MoEConfig``, ``MambaConfig``, ``ModelConfig``,
``register`` and ``get_config`` from the JAX package's
``repro/configs/base.py``, with the same fields and defaults so one config
describes the same model on both sides, and the same analytic
``param_count``. The dtype fields are names (``"float32"``,
``"bfloat16"``) that :func:`torch_dtype` turns into torch dtypes. The
registry holds the configs of the families the port builds (dense, vlm,
moe, ssm); the hybrid and encdec configs come with their families
(ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                         # expert hidden size
    capacity_factor: float = 1.25
    dense_residual: bool = False      # arctic: dense FFN in parallel w/ MoE
    every_n_layers: int = 1           # jamba: MoE on every other layer


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
    moe: Optional[MoEConfig] = None
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
        """Analytic total parameter count, as the JAX package counts it
        (the final norm left out)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tied_embeddings else 2)
        per_attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        if self.qkv_bias:
            per_attn += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim

        def ffn_params(ff):
            return (3 if self.act == "silu" else 2) * d * ff

        def per_mamba():
            m = self.mamba
            di = m.expand * d
            return (d * 2 * di                           # in_proj
                    + m.d_conv * di + di                 # conv + bias
                    + di * (m.rank(d) + 2 * m.d_state)   # x_proj
                    + m.rank(d) * di + di                # dt_proj + bias
                    + di * m.d_state + di                # A_log, D
                    + di * d)                            # out_proj
        if self.family in ("dense", "vlm", "audio"):
            return emb + self.n_layers * (per_attn + ffn_params(self.d_ff)
                                          + 2 * d)
        if self.family == "moe":
            moe = self.moe
            per_moe = moe.num_experts * ffn_params(moe.d_ff) \
                + d * moe.num_experts
            dense = ffn_params(self.d_ff) if moe.dense_residual else 0
            return emb + self.n_layers * (per_attn + per_moe + dense + 2 * d)
        if self.family == "ssm":
            return emb + self.n_layers * (per_mamba() + d)
        if self.family == "hybrid":
            moe = self.moe
            n_attn = self.n_layers // self.attn_period
            n_moe = self.n_layers // moe.every_n_layers
            return (emb + n_attn * per_attn
                    + (self.n_layers - n_attn) * per_mamba()
                    + n_moe * (moe.num_experts * ffn_params(moe.d_ff)
                               + d * moe.num_experts)
                    + (self.n_layers - n_moe) * ffn_params(self.d_ff)
                    + self.n_layers * 2 * d)
        if self.family == "encdec":
            enc = self.n_encoder_layers * (per_attn + ffn_params(self.d_ff)
                                           + 2 * d)
            dec = self.n_layers * (2 * per_attn + ffn_params(self.d_ff)
                                   + 3 * d)
            return emb + enc + dec
        return emb


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


def registered() -> list:
    """The name of every config the port has, sorted (each config module
    of this package imported)."""
    pkg = importlib.import_module("repro_torch.configs")
    for mod in pkgutil.iter_modules(pkg.__path__):
        if mod.name != "base":
            importlib.import_module(f"repro_torch.configs.{mod.name}")
    return sorted(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        mod = arch.replace("-", "_").replace(".", "_")
        try:
            importlib.import_module(f"repro_torch.configs.{mod}")
        except ModuleNotFoundError:
            raise KeyError(
                f"unknown arch {arch!r}: the port has "
                f"{', '.join(registered())}; the hybrid and encdec configs "
                "come with their families (ROADMAP.md, queue A)") from None
    return _REGISTRY[arch]
