"""repro_torch.serve — the CNN microbatching engine (port of
``repro/serve/cnn.py``)."""
from .cnn import CNNEngine, CNNServeConfig, ImageRequest, QueueFullError

__all__ = ["CNNEngine", "CNNServeConfig", "ImageRequest", "QueueFullError"]
