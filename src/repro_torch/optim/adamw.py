"""AdamW with decoupled weight decay, cosine schedule, global-norm clip.

The port of ``repro/optim/adamw.py`` as plain functions over nested dicts
of tensors (:mod:`repro_torch.tree`).  The arithmetic is the reference's,
in float32, with the moments kept in ``moment_dtype`` and the state on the
params' device.  Divisions are tensor by tensor, as in the reference:
PyTorch computes ``scalar / tensor`` as a reciprocal times the scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["AdamWConfig", "apply", "global_norm", "init", "schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"
    grad_accum_steps: int = 1          # microbatching: peak activation
                                       # memory scales ~1/accum_steps


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step``: linear warm-up, then cosine decay to
    ``min_lr_ratio * lr`` (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: AdamWConfig, params: Any) -> dict:
    """Zero moments in ``moment_dtype`` and step 0, on the params' device."""
    dt = dtype_of(cfg.moment_dtype)
    device = leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over the leaves (in order) of each leaf's float32
    sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in leaves(tree)))


def apply(cfg: AdamWConfig, grads: Any, params: Any, state: dict
          ) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm:
        scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                            / torch.clamp_min(gnorm, 1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    mdt = dtype_of(cfg.moment_dtype)

    def upd(g, p, m, v):
        g32 = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g32)
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        return ((p.to(torch.float32) - lr * delta).to(p.dtype),
                m32.to(mdt), v32.to(mdt))

    out = [upd(*ls) for ls in zip(leaves(grads), leaves(params),
                                  leaves(state["m"]), leaves(state["v"]))]
    new_params = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_params, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
