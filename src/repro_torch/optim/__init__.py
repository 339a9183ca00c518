"""repro_torch.optim — AdamW, its schedule and global-norm clipping (port
of ``repro/optim/optimizer.py``), and the int8 error-feedback gradient
all-reduce (port of ``repro/optim/compression.py``)."""
from .compression import allreduce_compressed, compress, init_errors
from .optimizer import (OptConfig, apply_updates, apply_updates_,
                        clip_by_global_norm, global_norm, init_opt_state,
                        schedule)

__all__ = ["OptConfig", "allreduce_compressed", "apply_updates",
           "apply_updates_", "clip_by_global_norm", "compress",
           "global_norm", "init_errors", "init_opt_state", "schedule"]
