"""repro_torch.checkpoint — atomic, async, keep-N checkpoints in the JAX
package's layout (port of ``repro/checkpoint/checkpointer.py``)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
