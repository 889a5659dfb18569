"""Synthetic data of the port: the reference's NumPy streams as tensors."""
from repro_torch.data.pipeline import DataConfig, batch_iterator, make_batch

__all__ = ["DataConfig", "batch_iterator", "make_batch"]
