"""Serve step factory.

The port of ``make_serve_step`` of ``repro/dist/steps.py``; the train
steps (single-program and ring-all-reduce) wait for the training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


def make_serve_step(model: Model) -> Callable:
    """``(params, cache, tok, pos) -> (next_tok, logits, cache)``: one
    greedy decode step (argmax sampling, deterministic)."""

    def serve(params, cache, tok, pos):
        """Decode one token per sequence and write it into the cache."""
        logits, new_cache = model.decode_step(params, cache, tok, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    return serve
