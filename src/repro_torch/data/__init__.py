"""repro_torch.data — the synthetic, index-based data pipeline (port of
``repro/data/pipeline.py``)."""
from .pipeline import DataConfig, IndexedDataset, PrefetchLoader

__all__ = ["DataConfig", "IndexedDataset", "PrefetchLoader"]
