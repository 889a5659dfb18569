"""Unified Model API + family dispatch.

The port of ``repro/models/model.py``.  ``build_model(cfg, max_seq,
device)`` returns a ``Model`` whose functions take and return torch
tensors on ``device`` (params in, tensors out).  ``max_seq`` sizes learned
position tables (whisper) only; every other family is length-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig

#: Families not ported yet, with the ROADMAP item that ports them.
NOT_PORTED = {
    "moe": "build_moe (ROADMAP.md queue 1, item 9)",
    "hybrid": "build_hybrid (ROADMAP.md queue 1, item 9)",
    "audio": "build_audio (ROADMAP.md queue 1, item 9)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    config: ModelConfig
    device: torch.device
    init: Callable[..., Any]             # (seed) -> params
    loss_fn: Callable[..., Any]          # (params, batch) -> (loss, metrics)
    prefill: Callable[..., Any]          # (params, batch) -> logits
    init_cache: Callable[..., Any]       # (batch, max_slots) -> cache
    decode_step: Callable[..., Any]      # (params, cache, tok, pos) -> (logits, cache)


def build_model(cfg: ModelConfig, max_seq: int = 4096,
                device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU; raises without one).  Raises NotImplementedError for a
    family that is not ported yet."""
    from repro_torch.models import transformer, xlstm
    dev = resolve_device(device)
    if cfg.family in ("dense", "vlm"):
        fns = transformer.build_dense(cfg, max_seq, dev)
    elif cfg.family == "ssm":
        fns = xlstm.build_xlstm(cfg, max_seq, dev)
    elif cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet: "
            f"{NOT_PORTED[cfg.family]}")
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return Model(cfg, dev, *fns)
