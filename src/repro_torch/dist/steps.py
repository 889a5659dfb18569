"""Train / serve step factories wiring models + optimizer + the ring.

The port of ``repro/dist/steps.py``:

* :func:`make_train_step`     -- single-program step, with optional
  gradient accumulation from ``AdamWConfig.grad_accum_steps``;
* :func:`make_rar_train_step` -- the paper-faithful data-parallel step:
  the batch splits over the ring's ``w`` workers, each worker takes grads
  on its shard, and the full flattened gradient is exchanged with the
  explicit ring-all-reduce of :mod:`repro_torch.dist.rar` before one
  AdamW update.  The reference runs the workers as one SPMD program over
  a ``"data"`` mesh of devices; one card holds the whole ring, so the
  port runs the workers one after another and keeps their gradients as
  the rows of one worker-stacked buffer;
* :func:`make_serve_step`     -- one greedy decode step against the cache.

Gradients come from ``torch.autograd``; the models train with their
kernels' branches off, as the reference's do (the CUDA kernels have no
backward).  Metrics are scalar dicts (``loss``/``grad_norm``/``lr`` at
minimum).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.dist.rar import ring_all_reduce
from repro_torch.models.layers import BATCH_AXES, shard_hint
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, tree_map, unflatten

RING_AXIS = "data"

#: Integer dtypes of each float width: bitwise row comparisons.
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass(frozen=True)
class RingMesh:
    """The port's counterpart of the reference's 1-D ``"data"`` mesh: the
    ring's logical GPU ids (a placement's GPUs, in ring order) and the one
    torch device that runs all of them."""
    gpu_ids: tuple[int, ...]
    device: torch.device | str = "cuda"
    axis_names: tuple[str, ...] = (RING_AXIS,)

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"a ring mesh is 1-D, got axes {self.axis_names}")
        object.__setattr__(self, "gpu_ids", tuple(int(g) for g in self.gpu_ids))
        if not self.gpu_ids:
            raise ValueError("a ring needs at least one GPU")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: len(self.gpu_ids)}


def _grads_and_loss(model: Model, ocfg: AdamWConfig, params, batch) -> tuple:
    """(grads, loss) on one batch, honouring ``grad_accum_steps``.

    Accumulation runs A microbatches (axis-0 splits) in order, sums their
    gradients and averages -- peak activation memory scales ~1/A while the
    averaged gradient matches the full-batch one up to float
    reassociation.  ``loss`` is detached.
    """
    flat = leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    tracked = unflatten(params, live)

    def grad_of(mb):
        with torch.enable_grad():
            loss, _aux = model.loss_fn(tracked, mb)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        return list(grads), loss.detach()

    A = max(int(ocfg.grad_accum_steps), 1)
    if A == 1:
        grads, loss = grad_of(batch)
        return unflatten(params, grads), loss

    def split(leaf, a):
        B = leaf.shape[0]
        if B % A != 0:
            raise ValueError(
                f"global batch {B} must be divisible by "
                f"grad_accum_steps={A}")
        return leaf[a * (B // A):(a + 1) * (B // A)]

    gsum = [torch.zeros_like(p) for p in flat]
    lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for a in range(A):
        grads, loss = grad_of(tree_map(lambda x: split(x, a), batch))
        gsum = [s + g for s, g in zip(gsum, grads)]
        lsum = lsum + loss
    return unflatten(params, [g / A for g in gsum]), lsum / A


def make_train_step(model: Model, ocfg: AdamWConfig) -> Callable:
    """``(params, opt, batch) -> (params, opt, metrics)``, single program."""

    def step(params, opt, batch):
        """One optimizer step on one global batch."""
        grads, loss = _grads_and_loss(model, ocfg, params, batch)
        new_params, new_opt, om = adamw.apply(ocfg, grads, params, opt)
        return new_params, new_opt, {"loss": loss, **om}

    return step


def _ravel_dtype(flat: list) -> torch.dtype:
    """``ravel_pytree``'s buffer dtype: the leaves' common result dtype."""
    return functools.reduce(torch.promote_types, [p.dtype for p in flat])


def _unravel(vec: torch.Tensor, like: list) -> list:
    """Split the flat ``vec`` back into leaves of ``like``'s shapes and
    dtypes (views where the dtype matches)."""
    out, off = [], 0
    for p in like:
        n = p.numel()
        out.append(vec[off:off + n].view(p.shape).to(p.dtype))
        off += n
    return out


def _rows_equal(buf: torch.Tensor) -> bool:
    """Whether every row of ``buf`` holds row 0's bits."""
    bits = buf.view(_BITS[buf.element_size()])
    return all(torch.equal(bits[i], bits[0]) for i in range(1, len(bits)))


def make_rar_train_step(model: Model, ocfg: AdamWConfig,
                        mesh: RingMesh) -> Callable:
    """Explicit ring-all-reduce data-parallel step over ``mesh``.

    ``mesh`` must be 1-D over axis ``"data"``; its GPU ids are the ring's
    workers, all run on ``mesh.device`` one after another.  Params and
    optimizer state are shared; the batch's leading dim must be divisible
    by the ring width ``w``.  Each worker takes grads on its shard (the
    shards in worker order, as ``P("data")`` splits the reference's batch)
    and flattens them in ``ravel_pytree``'s order into its row of a
    ``[w, d]`` buffer; the ring sums the rows in place -- ``2 d (w-1)/w``
    bytes a worker, the §3 exchange volume -- and every row comes out the
    same bits, the port's form of "parameters stay bitwise replicated"
    (metric ``replicated``).  Row 0 divided by ``w`` is the gradient of one
    AdamW update; the loss is the workers' losses summed in order over
    ``w``.
    """
    if RING_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh must carry a {RING_AXIS!r} axis, "
                         f"got {mesh.axis_names}")
    w = int(mesh.shape[RING_AXIS])

    def step(params, opt, batch):
        """Local grads per worker, ring exchange, one update."""
        if leaves(params)[0].device.type != mesh.device.type:
            raise ValueError(f"params on {leaves(params)[0].device}, the "
                             f"ring on {mesh.device}")
        B = leaves(batch)[0].shape[0]
        if B % w:
            raise ValueError(f"batch {B} must divide over the ring's "
                             f"{w} workers")
        if w == 1:
            grads, loss = _grads_and_loss(model, ocfg, params, batch)
            replicated = True
        else:
            flat = leaves(params)
            d = sum(p.numel() for p in flat)
            buf = torch.empty((w, d), dtype=_ravel_dtype(flat),
                              device=flat[0].device)
            b, losses = B // w, []
            for i in range(w):
                shard = tree_map(lambda x: x[i * b:(i + 1) * b], batch)
                g, loss_i = _grads_and_loss(model, ocfg, params, shard)
                off = 0
                for leaf in leaves(g):
                    buf[i, off:off + leaf.numel()] = leaf.reshape(-1)
                    off += leaf.numel()
                del g
                losses.append(loss_i)
            ring_all_reduce(buf, out=buf)
            replicated = _rows_equal(buf)
            vec = buf[0] / w
            del buf
            grads = unflatten(params, _unravel(vec, flat))
            loss = sum(losses) / w
        new_params, new_opt, om = adamw.apply(ocfg, grads, params, opt)
        return new_params, new_opt, {"loss": loss, **om,
                                     "replicated": replicated}

    return step


def make_serve_step(model: Model) -> Callable:
    """``(params, cache, tok, pos) -> (next_tok, logits, cache)``: one
    greedy decode step (argmax sampling, deterministic)."""

    def serve(params, cache, tok, pos):
        """Decode one token per sequence and write it into the cache."""
        logits, new_cache = model.decode_step(params, cache, tok, pos)
        # each row's whole vocabulary on one device (a no-op off a mesh)
        next_tok = torch.argmax(shard_hint(logits, BATCH_AXES),
                                dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    return serve
