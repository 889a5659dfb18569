"""Explicit ring-all-reduce collectives (paper §3, Fig. 1) on a worker axis.

The port of ``repro/dist/rar.py``.  The reference is one SPMD program:
``jax.shard_map`` over a 1-D ``"data"`` mesh, each worker holding its own
shard, the ring built from ``jax.lax.ppermute``.  One H100 holds one
worker of such a program, so the port runs the whole ring in one process
on a **worker-stacked tensor**: row ``i`` of ``x: [w, ...]`` is worker
``i``'s local value, and row ``i`` of each result is worker ``i``'s
result -- exactly the per-shard views that ``in_specs=P("data")`` gives
the reference.  Each ring step is the reference's ``ppermute`` "left"
(worker ``j`` sends to ``j - 1``) as one ``torch.roll`` along the worker
axis, followed by the reference's add in the reference's order, so the
float results are bitwise those of the reference ring.

* **Share-Reduce** (:func:`ring_reduce_scatter`): ``w - 1`` steps; worker
  ``i`` ends up owning the fully reduced chunk ``i``;
* **Share-Only** (:func:`ring_all_gather`): ``w - 1`` steps circulate the
  reduced chunks until every worker holds all of them.

Per iteration each worker sends ``2 d (w - 1) / w`` bytes
(:func:`exchange_bytes_per_worker`).  :data:`RING` counts the ring steps
and the bytes each worker sent since :func:`reset_ring_counts`: the
counterpart of counting the collective-permutes in the reference's HLO.
Chunking flattens each worker's value and zero-pads it to a multiple of
``w``; ``w == 1`` is the identity (no communication).
"""
from __future__ import annotations

import torch

__all__ = ["RING", "axis_size", "exchange_bytes_per_worker",
           "reset_ring_counts", "ring_all_gather", "ring_all_reduce",
           "ring_counts", "ring_reduce_scatter"]

#: Ring steps taken and bytes each worker sent since the last reset.
RING = {"steps": 0, "bytes": 0}


def ring_counts() -> dict[str, int]:
    """Snapshot of :data:`RING`."""
    return dict(RING)


def reset_ring_counts() -> None:
    """Zero :data:`RING`."""
    for key in RING:
        RING[key] = 0


def axis_size(x: torch.Tensor) -> int:
    """Width ``w`` of the ring: the size of the worker axis (dim 0)."""
    if x.dim() < 1:
        raise ValueError("a worker-stacked tensor needs a leading worker axis")
    return int(x.shape[0])


def exchange_bytes_per_worker(d: float, w: int) -> float:
    """Bytes each worker sends per RAR iteration for a ``d``-byte gradient.

    §3: ``2 d (w - 1) / w`` -- each of the ``2(w - 1)`` ring steps moves a
    ``d / w`` chunk.  The degenerate single-worker ring exchanges nothing.
    """
    if w < 1:
        raise ValueError(f"ring width must be >= 1, got {w}")
    if w == 1:
        return 0.0
    return 2.0 * d * (w - 1) / w


def _ring_chunks(x: torch.Tensor, w: int) -> torch.Tensor:
    """Flatten each worker's row of ``x: [w, ...]`` and split it into
    ``w`` equal chunks, zero-padding the tail when a row's size is not a
    multiple of ``w``.  Returns ``[w, w, m]`` (a view of ``x`` when no
    padding is needed)."""
    flat = x.reshape(w, -1)
    n = flat.shape[1]
    m = -(-n // w)
    if m * w != n:
        flat = torch.nn.functional.pad(flat, (0, m * w - n))
    return flat.reshape(w, w, m)


def _send_left(buf: torch.Tensor) -> torch.Tensor:
    """One ring step: worker ``j`` sends its row to worker ``j - 1``, so
    row ``i`` of the result is row ``i + 1`` (mod ``w``) of ``buf``."""
    RING["steps"] += 1
    RING["bytes"] += buf[0].numel() * buf.element_size()
    return torch.roll(buf, -1, dims=0)


def ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """Share-Reduce phase: ``w - 1`` steps around the ring.

    ``x: [w, ...]`` holds each worker's contribution; row ``i`` of the
    result is the fully reduced chunk ``i`` of the (zero-padded) flattened
    sum, ``ceil(x[0].numel() / w)`` elements: ``[w, m]``.
    """
    w = axis_size(x)
    chunks = _ring_chunks(x, w)                          # [w, w, m]
    if w == 1:
        return chunks[:, 0].clone()
    rows = torch.arange(w, device=x.device)
    # the partial for chunk c starts at worker c - 1 and gains one local
    # contribution per hop until worker c owns it
    partial = chunks[rows, (rows + 1) % w]
    for t in range(w - 1):
        partial = _send_left(partial)
        for i in range(w):
            partial[i] += chunks[i, (i + t + 2) % w]
    return partial


def ring_all_gather(chunk: torch.Tensor, *, out: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Share-Only phase: ``w - 1`` steps circulate the reduced chunks.

    ``chunk: [w, m, ...]``: worker ``i`` holds logical chunk ``i`` (the
    :func:`ring_reduce_scatter` convention).  Every worker returns the
    concatenation of all ``w`` chunks in index order, ``[w, w * m, ...]``,
    written into ``out`` when given (a tensor of that shape and dtype on
    the same device).
    """
    w = axis_size(chunk)
    m = chunk.shape[1:]
    if out is None:
        out = chunk.new_empty((w, w * m[0]) + m[1:])
    elif out.shape != (w, w * m[0]) + m[1:] or out.dtype != chunk.dtype \
            or out.device != chunk.device:
        raise ValueError(f"out: {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, expected {(w, w * m[0]) + m[1:]} "
                         f"{chunk.dtype} on {chunk.device}")
    slots = out.view((w, w) + m)
    for i in range(w):
        slots[i, i] = chunk[i]
    buf = chunk
    for t in range(w - 1):
        buf = _send_left(buf)
        for i in range(w):
            slots[i, (i + t + 1) % w] = buf[i]
    return out


def ring_all_reduce(x: torch.Tensor, *, out: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Full RAR: Share-Reduce then Share-Only, ``2(w - 1)`` steps in all.

    ``x: [w, ...]``; returns the elementwise sum over the workers in every
    row -- numerically a ring-ordered reassociation of a sum over dim 0 --
    with ``x``'s shape and dtype.  ``out`` (``x``'s shape, dtype and
    device; ``x`` itself is allowed) receives the result without a second
    ``[w, ...]`` buffer when each row's size is a multiple of ``w``.
    """
    w = axis_size(x)
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"out: {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, expected {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if w == 1:
        return x.clone() if out is None else out.copy_(x)
    n = x[0].numel()
    chunk = ring_reduce_scatter(x)
    if n == chunk.shape[1] * w and out is not None and out.is_contiguous():
        ring_all_gather(chunk, out=out.view(w, n))
        return out
    full = ring_all_gather(chunk)[:, :n].reshape(x.shape)
    return full if out is None else out.copy_(full)
