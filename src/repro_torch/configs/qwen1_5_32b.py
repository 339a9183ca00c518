"""Qwen1.5-32B [dense] — full MHA-width GQA (kv=40), QKV bias
[hf:Qwen/Qwen1.5-32B]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1e6, act="silu",
))
