"""Unified Model API + family dispatch.

The port of ``repro/models/model.py``.  ``build_model(cfg, max_seq,
device)`` returns a ``Model`` whose functions take and return torch
tensors on ``device`` (params in, tensors out).  ``max_seq`` sizes learned
position tables (whisper) only; every other family is length-agnostic.
On the ``meta`` device ``init`` gives the param tree's shapes and dtypes
and allocates nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    config: ModelConfig
    device: torch.device
    init: Callable[..., Any]             # (seed) -> params
    loss_fn: Callable[..., Any]          # (params, batch) -> (loss, metrics)
    prefill: Callable[..., Any]          # (params, batch) -> logits
    init_cache: Callable[..., Any]       # (batch, max_slots) -> cache
    decode_step: Callable[..., Any]      # (params, cache, tok, pos) -> (logits, cache)
    encode: Callable[..., Any] | None = None   # audio: (params, frames) -> enc_out


def build_model(cfg: ModelConfig, max_seq: int = 4096,
                device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU or the ``meta`` device; raises without a card)."""
    from repro_torch.models import transformer, xlstm
    dev = resolve_device(device, meta=True)
    if cfg.family in ("dense", "vlm"):
        fns = transformer.build_dense(cfg, max_seq, dev)
    elif cfg.family == "moe":
        fns = transformer.build_moe(cfg, max_seq, dev)
    elif cfg.family == "hybrid":
        fns = transformer.build_hybrid(cfg, max_seq, dev)
    elif cfg.family == "audio":
        fns = transformer.build_audio(cfg, max_seq, dev)
    elif cfg.family == "ssm":
        fns = xlstm.build_xlstm(cfg, max_seq, dev)
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return Model(cfg, dev, *fns)
