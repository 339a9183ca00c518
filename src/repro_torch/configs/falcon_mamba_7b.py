"""Falcon-Mamba-7B [ssm] — attention-free Mamba-1, d_state=16
[arXiv:2410.05355]."""
from .base import MambaConfig, ModelConfig, register

register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024, act="silu",
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
))
