"""IBM Granite 3.0 1B-A400M [moe] — 32 experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from .base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, tied_embeddings=True, rope_theta=1e4, act="silu",
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512),
))
