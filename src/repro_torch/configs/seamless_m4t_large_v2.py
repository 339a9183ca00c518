"""SeamlessM4T-large v2 [audio] — encoder-decoder text/speech backbone
[arXiv:2308.11596]. Speech frontend is a STUB: input_specs() supplies
precomputed frame embeddings (B, S_enc, d_model)."""
from .base import ModelConfig, register

register(ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, act="gelu",
    frontend_positions=0,   # encoder length comes from the shape config
))
