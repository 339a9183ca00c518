"""repro_torch.check — static checks the port needs (serve-config
validation, :mod:`~repro_torch.check.config`)."""
from .config import check_cnn_serve_config, check_serve_config

__all__ = ["check_cnn_serve_config", "check_serve_config"]
