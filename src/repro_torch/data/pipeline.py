"""Synthetic data pipeline: deterministic, shardable, family-aware.

The port of ``repro/data/pipeline.py``: the same NumPy generator, seeded
with the same tuple ``(seed, step, hash(cfg.name) & 0xFFFF)``, so within
one process both packages draw identical batches.  Python randomises
``str`` hashes per process, so the stream of one ``DataConfig`` differs
from one process to the next (in both packages).  Token streams follow a
Zipf distribution; modality stubs (patches/frames) are unit Gaussians.
The batches come back as tensors on the caller's device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import InputShape, ModelConfig

__all__ = ["DataConfig", "batch_iterator", "make_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.3


def _tokens(rng: np.random.Generator, shape, vocab: int, a: float):
    z = rng.zipf(a, size=shape)
    return ((z - 1) % vocab).astype(np.int32)


def _numpy_batch(cfg: ModelConfig, shape: InputShape, step: int,
                 data_cfg: DataConfig, batch_override: int | None) -> dict:
    rng = np.random.default_rng((data_cfg.seed, step, hash(cfg.name) & 0xFFFF))
    B = batch_override or shape.global_batch
    S = shape.seq_len
    if cfg.family == "vlm":
        return {
            "tokens": _tokens(rng, (B, S - cfg.n_patches), cfg.vocab,
                              data_cfg.zipf_a),
            "patches": rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model), dtype=np.float32),
        }
    if cfg.family == "audio":
        return {
            "frames": rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model), dtype=np.float32),
            "tokens": _tokens(rng, (B, S), cfg.vocab, data_cfg.zipf_a),
        }
    return {"tokens": _tokens(rng, (B, S), cfg.vocab, data_cfg.zipf_a)}


def make_batch(cfg: ModelConfig, shape: InputShape, step: int,
               data_cfg: DataConfig = DataConfig(),
               batch_override: int | None = None, device="cuda") -> dict:
    """Deterministic global batch for (arch, shape, step) on ``device``
    (int32 tokens, float32 patches/frames)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in _numpy_batch(cfg, shape, step, data_cfg,
                                     batch_override).items()}


def batch_iterator(cfg: ModelConfig, shape: InputShape,
                   data_cfg: DataConfig = DataConfig(),
                   batch_override: int | None = None,
                   device="cuda") -> Iterator[dict]:
    """``make_batch`` for steps 0, 1, 2, ..."""
    step = 0
    while True:
        yield make_batch(cfg, shape, step, data_cfg, batch_override, device)
        step += 1
