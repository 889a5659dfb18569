"""Optimizer of the port: AdamW over nested dicts of tensors."""
from repro_torch.optim.adamw import (AdamWConfig, apply, global_norm, init,
                                     schedule)

__all__ = ["AdamWConfig", "apply", "global_norm", "init", "schedule"]
