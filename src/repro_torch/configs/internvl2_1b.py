"""InternVL2-1B [vlm] — InternViT frontend (STUB) + InternLM2-chat-1b-style
backbone [arXiv:2404.16821]. Backbone config verbatim from the assignment;
the vision tower is not modelled: its precomputed patch embeddings come in
through ``prefill``'s ``embeds``."""
from .base import ModelConfig, register

register(ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655,
    qkv_bias=True, tied_embeddings=True, rope_theta=1e6,
    frontend_positions=256, act="silu",
))
