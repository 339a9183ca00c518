"""Jamba v0.1 52B [hybrid] — Mamba:attention 1:7 interleave (attn every 8
layers at offset 4), MoE (16e top-2) on every other layer [arXiv:2403.19887]."""
from .base import MambaConfig, ModelConfig, MoEConfig, register

register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, act="silu",
    attn_period=8, attn_offset=4,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336, every_n_layers=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
))
