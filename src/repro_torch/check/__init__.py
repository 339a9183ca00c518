"""repro_torch.check — static checks the port needs (serve-config
validation, :mod:`~repro_torch.check.config`)."""
from .config import (check_cnn_serve_config, check_serve_config,
                     kv_cache_bytes, paged_num_blocks)

__all__ = ["check_cnn_serve_config", "check_serve_config", "kv_cache_bytes",
           "paged_num_blocks"]
