"""Checkpoints of the port: the reference's flat-npz layout."""
from repro_torch.ckpt.checkpoint import load, save

__all__ = ["load", "save"]
