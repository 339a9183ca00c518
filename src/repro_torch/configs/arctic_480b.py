"""Snowflake Arctic 480B [moe] — 128-expert top-2 MoE with a parallel dense
residual FFN per layer [hf:Snowflake/snowflake-arctic-base]."""
from .base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, rope_theta=1e6, act="silu",
    moe=MoEConfig(num_experts=128, top_k=2, d_ff=4864, dense_residual=True),
))
