"""Mesh / placement rules for the production dry-run, on DTensor.

The port of ``repro/dist/sharding.py``: the same three declarative rule
sets, under the same names, as pure shape functions --

* :func:`param_specs`  -- params and optimizer moments: tensor-parallel over
  ``"model"`` on the largest divisible dim, then ZeRO-3-style over
  ``"data"`` on the largest remaining divisible dim (moments shard exactly
  like their params);
* :func:`batch_specs`  -- inputs: leading (batch) dim over the data-parallel
  axes ``("pod", "data")``;
* :func:`cache_specs`  -- decode caches: batch dim over the data axes, KV
  heads (or, for ``seq_shard`` long-context serving, the slot axis) over
  ``"model"``.

Every rule only applies an axis when it exists in the mesh and divides the
dim, so the same code serves the 512-device dry-run and a 1x1 mesh.
``REPRO_NAIVE_SHARDING=1`` drops param/cache sharding to fully replicated --
the baseline the dry-run compares against.

A spec is :class:`P`, a tuple of per-dim entries (``None``, an axis name,
or a tuple of names), read the way ``jax.sharding.PartitionSpec`` reads.
:func:`named` turns a spec tree into DTensor placements, one per mesh dim;
:func:`distribute` places a tree of tensors by a spec tree (the
counterpart of ``jax.jit``'s ``in_shardings``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"
ZERO_AXIS = "data"          # ZeRO-3 shards params/moments over "data" only:
                            # "pod" crosses the inter-server network, too
                            # slow for weight gathers


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of axis names); trailing dims not listed are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of a nested dict / dataclass tree (a
    dataclass's ``None`` fields stay ``None``); a :class:`P` is a leaf."""
    if isinstance(tree, P) or isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: None if getattr(tree, f.name) is None
            else _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"not a spec/param tree node: {type(tree).__name__}")


def _map2(fn: Callable, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: None if getattr(tree, f.name) is None
            else _map2(fn, getattr(tree, f.name), getattr(specs, f.name))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"not a param tree node: {type(tree).__name__}")


def _naive() -> bool:
    return bool(os.environ.get("REPRO_NAIVE_SHARDING"))


def _axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or of any object with its
    ``mesh_dim_names`` and ``shape``)."""
    return {name: int(size) for name, size in
            zip(mesh.mesh_dim_names, tuple(mesh.shape))}


def _largest_divisible(shape, size: int, used: set[int]) -> int | None:
    """Index of the largest dim divisible by ``size`` (ties -> first),
    excluding ``used``; None when nothing qualifies or ``size`` is 1."""
    if size <= 1:
        return None
    best, best_dim = None, 0
    for i, d in enumerate(shape):
        if i in used or d % size != 0 or d < size:
            continue
        if d > best_dim:
            best, best_dim = i, d
    return best


def leaf_spec(shape, mesh) -> P:
    """Model-then-ZeRO spec for one parameter/moment leaf."""
    sizes = _axis_sizes(mesh)
    spec: list = [None] * len(shape)
    used: set[int] = set()
    mi = _largest_divisible(shape, sizes.get(MODEL_AXIS, 1), used)
    if mi is not None:
        spec[mi] = MODEL_AXIS
        used.add(mi)
    zi = _largest_divisible(shape, sizes.get(ZERO_AXIS, 1), used)
    if zi is not None:
        spec[zi] = ZERO_AXIS
    return P(*spec)


def param_specs(tree: Any, mesh, cfg=None) -> Any:
    """Spec tree for a params / optimizer-state tree.

    ``cfg`` is accepted for future per-arch overrides; the current rules
    are purely shape-driven.  Under ``REPRO_NAIVE_SHARDING`` everything is
    replicated (the dry-run baseline).
    """
    del cfg
    if _naive():
        return _map(lambda leaf: P(), tree)
    return _map(lambda leaf: leaf_spec(tuple(leaf.shape), mesh), tree)


def _batch_axes_for(dim: int, mesh) -> tuple[str, ...]:
    """The prefix of ("pod", "data") present in the mesh whose product
    divides ``dim`` (the largest usable data-parallel group)."""
    sizes = _axis_sizes(mesh)
    axes = [a for a in BATCH_AXES if sizes.get(a, 1) > 1]
    while axes:
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if prod <= dim and dim % prod == 0:
            return tuple(axes)
        axes.pop(0)          # drop "pod" first: keep intra-pod parallelism
    return ()


def batch_specs(tree: Any, mesh) -> Any:
    """Shard the leading (global-batch) dim of every input leaf over the
    data-parallel axes.  Works for train/prefill batch dicts and for the
    decode ``{"tok": [B], "pos": [B]}`` pair alike."""

    def spec(leaf):
        """Batch-dim spec for one input leaf."""
        axes = _batch_axes_for(leaf.shape[0], mesh) if leaf.ndim else ()
        if not axes:
            return P()
        first = axes if len(axes) > 1 else axes[0]
        return P(first, *([None] * (leaf.ndim - 1)))

    return _map(spec, tree)


def _cache_leaf_spec(shape, mesh, *, seq_shard: bool) -> P:
    """Spec for one stacked decode-cache leaf ``[L, B, ...rest]``.

    dim 0 is the stacked layer axis (never sharded), dim 1 the batch; for
    KV-shaped leaves dim 2 is the slot axis and dim 3 the KV heads.  The
    ``"model"`` axis goes on the slot axis when ``seq_shard`` (long-context
    rolling windows) else on the heads when they divide.
    """
    sizes = _axis_sizes(mesh)
    spec: list = [None] * len(shape)
    if len(shape) >= 2:
        axes = _batch_axes_for(shape[1], mesh)
        if axes:
            spec[1] = axes if len(axes) > 1 else axes[0]
    ms = sizes.get(MODEL_AXIS, 1)
    if ms > 1:
        if seq_shard and len(shape) >= 3 and shape[2] % ms == 0:
            spec[2] = MODEL_AXIS
        elif len(shape) >= 4 and shape[3] % ms == 0 and shape[3] >= ms:
            spec[3] = MODEL_AXIS
    return P(*spec)


def cache_specs(cache: Any, mesh, *, seq_shard: bool = False) -> Any:
    """Spec tree for a ``Model.init_cache`` tree.

    Handles the stacked-layer subtrees (``"kv"``, ``"kv_dense"``, ``"ssm"``,
    ``"mlstm"``, ``"slstm"``) and the unstacked audio ``"enc_out"``
    ``[B, frames, d]`` buffer.
    """
    if _naive():
        return _map(lambda leaf: P(), cache)

    out = {}
    for key, sub in cache.items():
        if key == "enc_out":
            axes = _batch_axes_for(sub.shape[0], mesh)
            first = axes if len(axes) > 1 else (axes[0] if axes else None)
            out[key] = P(first, *([None] * (sub.ndim - 1)))
        else:
            out[key] = _map(lambda leaf: _cache_leaf_spec(
                tuple(leaf.shape), mesh, seq_shard=seq_shard), sub)
    return out


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(i)`` where tensor dim ``i`` names that mesh axis, else
    ``Replicate()``.  A dim split over several axes lists them major to
    minor, in mesh order (GSPMD's order, and DTensor's)."""
    names = tuple(mesh.mesh_dim_names)
    where: dict[str, int] = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {names}")
        for a in axes:
            where[a] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def named(spec_tree: Any, mesh) -> Any:
    """The placements tree of a spec tree on ``mesh`` (the form
    :func:`distribute` and ``redistribute`` consume)."""
    return _map(lambda s: placements(s, mesh), spec_tree)


def distribute(tree: Any, spec_tree: Any, mesh) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh``, placed by its
    spec in ``spec_tree``.  Every rank takes its own shard of its own
    full tensor: nothing is sent."""
    return _map2(lambda t, s: distribute_tensor(
        t, mesh, placements(s, mesh), src_data_rank=None), tree, spec_tree)
