"""repro_torch.optim — AdamW, its schedule and global-norm clipping (port
of ``repro/optim/optimizer.py``)."""
from .optimizer import (OptConfig, apply_updates, apply_updates_,
                        clip_by_global_norm, global_norm, init_opt_state,
                        schedule)

__all__ = ["OptConfig", "apply_updates", "apply_updates_",
           "clip_by_global_norm",
           "global_norm", "init_opt_state", "schedule"]
