"""IBM Granite 34B code [dense] — GPTBigCode-lineage, MQA (kv=1), GELU MLP
[arXiv:2405.04324]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, act="gelu", rope_theta=1e4,
))
