"""repro_torch.serve — the CNN microbatching engine and the continuous-
batching LM engine (ports of ``repro/serve/cnn.py`` and
``repro/serve/engine.py``)."""
from .cnn import CNNEngine, CNNServeConfig, ImageRequest
from .engine import Engine, QueueFullError, Request, ServeConfig

__all__ = ["CNNEngine", "CNNServeConfig", "Engine", "ImageRequest",
           "QueueFullError", "Request", "ServeConfig"]
