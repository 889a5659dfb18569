"""Multi-pod dry-run: run every (arch x input-shape x mesh) step once on
DTensors over a fake process group, and count what it costs per device.

The port of ``repro/launch/dryrun.py``.  This is the no-hardware proof
that the distribution config holds together: every assigned
architecture, at every assigned input shape, must run against the
production meshes --

    single-pod : (data=16, model=16)           = 256 devices
    multi-pod  : (pod=2, data=16, model=16)    = 512 devices

in ONE process: the mesh sits on a ``"fake"`` process group of that world
size (rank 0; collectives are recorded, never sent) and every tensor is a
``FakeTensorMode`` tensor, so full width allocates nothing.  The params,
AdamW state, inputs and caches are DTensors placed by
``dist/sharding.py``; DTensor turns each op into the local op on rank 0's
shard plus the collectives it needs.  For each pair we print per-device
memory (does it fit 80 GiB?), FLOPs, bytes and collective bytes with the
inter-pod (DCN) share, and the roofline bottleneck under the H100
constants (``launch/roofline.py``).  The model runs with
``use_flash_kernel=False``, its default: no kernel runs on fake tensors.

Usage (on the card, or ``--device cpu`` on any host)::

    python -m repro_torch.launch.dryrun                    # full matrix, 1 pod
    python -m repro_torch.launch.dryrun --multi-pod        # full matrix, 2 pods
    python -m repro_torch.launch.dryrun --both-meshes
    python -m repro_torch.launch.dryrun --device cpu --arch llama3-405b \\
        --shape train_4k
    python -m repro_torch.launch.dryrun --json out.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCHS, INPUT_SHAPES, cache_slots,
                                 get_config, input_specs, supported_shapes)
from repro_torch.dist import sharding as shd
from repro_torch.dist.steps import make_serve_step, make_train_step
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig


def _shape(shape_name, batch_override: int | None = None) -> InputShape:
    shape = shape_name if isinstance(shape_name, InputShape) \
        else INPUT_SHAPES[shape_name]
    if batch_override:
        shape = dataclasses.replace(shape, global_batch=batch_override)
    return shape


def _inputs(cfg, shape: InputShape, device, seed: int = 0) -> dict:
    """The inputs of ``input_specs(cfg, shape)`` on ``device``: tokens
    drawn in [0, vocab), decode positions at the last slot of the context
    (``seq_len - 1``), float inputs standard normal."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for key, spec in input_specs(cfg, shape).items():
        if key == "pos":
            out[key] = torch.full(spec.shape, shape.seq_len - 1,
                                  dtype=spec.dtype, device=device)
        elif spec.dtype.is_floating_point:
            out[key] = torch.randn(spec.shape, generator=gen,
                                   dtype=spec.dtype, device=device)
        else:
            out[key] = torch.randint(0, cfg.vocab, spec.shape, generator=gen,
                                     dtype=spec.dtype, device=device)
    return out


def build_step(arch: str, shape_name, mesh, *, cfg=None,
               opt_overrides: dict | None = None) -> tuple:
    """Returns (step_fn, args): the step of (arch, shape) and its
    arguments as DTensors on ``mesh``.

    Params and the AdamW state are placed by ``param_specs``, inputs by
    ``batch_specs``, the decode cache by ``cache_specs`` (``seq_shard``
    for ``long_500k``).  ``cfg`` replaces the arch's config (the tests
    pass a ``reduced()`` one) and ``shape_name`` may be an
    :class:`InputShape`.  Under ``FakeTensorMode`` nothing is allocated;
    otherwise the params are the seeded init on the mesh's device."""
    cfg = cfg or get_config(arch)
    shape = _shape(shape_name)
    dev = torch.device(mesh.device_type)
    model = build_model(cfg, max_seq=min(shape.seq_len, 65536), device=dev)
    params = model.init(0)
    params_d = shd.distribute(params, shd.param_specs(params, mesh, cfg),
                              mesh)

    if shape.kind == "train":
        ocfg = AdamWConfig(**(opt_overrides or {}))
        opt = adamw.init(ocfg, params)
        del params
        opt_d = shd.distribute(opt, shd.param_specs(opt, mesh, cfg), mesh)
        batch = _inputs(cfg, shape, dev)
        batch_d = shd.distribute(batch, shd.batch_specs(batch, mesh), mesh)
        return make_train_step(model, ocfg), (params_d, opt_d, batch_d)
    del params

    if shape.kind == "prefill":
        batch = _inputs(cfg, shape, dev)
        batch_d = shd.distribute(batch, shd.batch_specs(batch, mesh), mesh)

        def prefill_step(params, batch):
            """Serving prefill: sampling needs only the last position --
            the full [B, S, V] logits slab is not the output."""
            with torch.no_grad():
                logits = model.prefill(params, batch)
            if os.environ.get("REPRO_NAIVE_SHARDING"):
                return logits                      # baseline: full slab out
            return logits[:, -1, :]

        return prefill_step, (params_d, batch_d)

    # decode: one new token against a seq_len KV cache / recurrent state
    cache = model.init_cache(shape.global_batch, cache_slots(cfg, shape))
    c_spec = shd.cache_specs(cache, mesh,
                             seq_shard=shape.name == "long_500k")
    cache_d = shd.distribute(cache, c_spec, mesh)
    del cache
    io = _inputs(cfg, shape, dev)
    io_d = shd.distribute(io, shd.batch_specs(io, mesh), mesh)
    serve = make_serve_step(model)

    def decode_step(params, cache, tok, pos):
        """One greedy decode step; the cache is updated in place."""
        with torch.no_grad():
            return serve(params, cache, tok, pos)

    return decode_step, (params_d, cache_d, io_d["tok"], io_d["pos"])


_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default}


def _view_groups(src: tuple, dst: tuple) -> list[tuple[list, list]]:
    """The (src dims, dst dims) groups of ``view(src -> dst)``: runs of
    src dims merged into one dst dim, or one src dim split into a run of
    dst dims (size-1 dims dropped from both)."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        gs, gd = [i], [j]
        a, b = src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                gs.append(i)
                a *= src[i]
                i += 1
            else:
                gd.append(j)
                b *= dst[j]
                j += 1
        groups.append(([d for d in gs if src[d] > 1],
                       [d for d in gd if dst[d] > 1]))
    return groups


class FlatViews(TorchDispatchMode):
    """Keeps DTensor's placements plain where a view reshapes sharded
    dims: before a view, a mesh axis is gathered (an all-gather the
    counter sees) where it splits a dim that the view merges into an
    earlier one, a dim it splits unevenly that the view merges with
    later ones, or a dim that the view splits into parts whose first
    part the axis does not divide.

    DTensor would otherwise express the first (the tokens of ``[B, S] ->
    [B * S]`` with S split over ``"model"``, as DTensor's own
    reduce-scatter of a partial sum before a nonlinearity leaves them) as
    a strided placement, whose redistribution planner searches every path
    through strided states (minutes per op on a 3-D mesh), and refuses
    the second (8 KV heads of a 512-wide projection split 16 ways).  A
    local shard that is not contiguous (an uneven split's view) is made
    so first: its local view would fail."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        x = args[0] if args else None
        if func in _VIEWS and isinstance(x, DTensor):
            size = list(args[1])
            if -1 in size:
                known = math.prod(d for d in size if d != -1)
                size[size.index(-1)] = x.numel() // max(known, 1)
            sizes = tuple(x.device_mesh.shape)

            def ways(dim):
                return math.prod(m for m, p in zip(sizes, x.placements)
                                 if isinstance(p, Shard) and p.dim == dim)

            gather = set()
            for gs, gd in _view_groups(tuple(x.shape), tuple(size)):
                if len(gs) > 1:
                    gather.update(gs[1:])
                    if x.shape[gs[0]] % ways(gs[0]):
                        gather.add(gs[0])
                elif len(gd) > 1 and size[gd[0]] % ways(gs[0]):
                    gather.add(gs[0])
            pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in gather
                       else p for p in x.placements)
            if pl != tuple(x.placements):
                x = x.redistribute(x.device_mesh, pl)
            if not x.to_local().is_contiguous():     # an uneven shard's view
                x = x.contiguous()
            args = (x,) + tuple(args[1:])
        return func(*args, **(kwargs or {}))


def _pod_size(mesh) -> int:
    """Ranks per pod on a mesh with a ``"pod"`` axis, else 0."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return 0
    return mesh.size() // mesh.shape[names.index("pod")]


def _sync(device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.synchronize()


def dry_run(arch: str, shape_name, mesh, *, cfg=None,
            opt_overrides: dict | None = None,
            batch_override: int | None = None, fake: bool = True) -> dict:
    """Build and run the step of (arch, shape) once on ``mesh`` under a
    :class:`~repro_torch.launch.roofline.CostCounter`; returns the
    reference's row keys plus ``run_s`` (build and run: eager has no
    compile), the collective counts and bytes by kind, ``dcn_bytes``,
    ``args_bytes`` and ``param_bytes`` (this device's share of the step's
    inputs and of the params).

    ``fake`` (the default) builds everything under ``FakeTensorMode``.
    With ``fake=False`` the step runs on real tensors (a real process
    group, e.g. one rank on the card): the peak memory is then the card's,
    and ``wall_s`` is a second, uncounted run timed to a synchronize."""
    cfg = cfg or get_config(arch)
    shape = _shape(shape_name, batch_override)
    t0 = time.perf_counter()
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else None
    if fake:
        # Build under the mode; run with it off: fake tensors dispatch
        # through their own mode all the same, while the small index
        # tensors DTensor's sharding propagation makes and reads back
        # (``.tolist()``) stay real.
        with mode:
            fn, args = build_step(arch, shape, mesh, cfg=cfg,
                                  opt_overrides=opt_overrides)
    else:
        fn, args = build_step(arch, shape, mesh, cfg=cfg,
                              opt_overrides=opt_overrides)
    with implicit_replication():
        counter = roofline.CostCounter(_pod_size(mesh), fake_mode=mode)
        def step(*a):
            with FlatViews():
                return fn(*a)

        with counter:
            _, mem = roofline.memory_peak(step, args, fake_mode=mode)
        args_bytes = roofline.local_bytes(args)
        param_bytes = roofline.local_bytes(args[0])
        wall = None
        if not fake:
            _sync(mesh.device_type)
            t_w = time.perf_counter()
            step(*args)
            _sync(mesh.device_type)
            wall = time.perf_counter() - t_w
    stats = counter.stats
    rl = roofline.Roofline(
        arch=arch, shape=shape.name,
        mesh="x".join(str(s) for s in tuple(mesh.shape)),
        chips=mesh.size(), hlo_flops=counter.flops, hlo_bytes=counter.bytes,
        collective_bytes=stats.total_bytes, collectives=stats,
        model_flops=roofline.model_step_flops(cfg, shape),
        per_device_hbm_peak=mem)
    row = rl.row()
    row["run_s"] = time.perf_counter() - t0
    row["collective_counts"] = dict(stats.count_by_kind)
    row["collective_bytes_by_kind"] = dict(stats.bytes_by_kind)
    row["dcn_bytes"] = stats.dcn_bytes
    row["args_bytes"] = args_bytes
    row["param_bytes"] = param_bytes
    if wall is not None:
        row["wall_s"] = wall
    return row


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             device="cuda", opt_overrides: dict | None = None,
             verbose: bool = True) -> dict:
    """The dry-run row of (arch, shape) on a production mesh, on fake
    tensors of ``device`` (the card unless the caller asks for the CPU;
    raises without a card)."""
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    row = dry_run(arch, shape_name, mesh, opt_overrides=opt_overrides)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {row['mesh']}: "
              f"run {row['run_s']:.3f}s, "
              f"mem/device {row['hbm_peak_bytes'] / 2**30:.2f} GiB of 80, "
              f"flops/device {row['hlo_flops']:.3e}, "
              f"bytes/device {row['hlo_bytes']:.3e}, "
              f"collective {row['collective_bytes']:.3e} B "
              f"({sum(row['collective_counts'].values())} ops, "
              f"dcn {row['dcn_bytes']:.3e} B), "
              f"bottleneck={row['bottleneck']}", flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch (default all)")
    ap.add_argument("--shape", default=None, help="single shape (default all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None, help="write rows to this file")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda or cpu)")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else sorted(ARCHS)
    rows, failures = [], []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else supported_shapes(cfg)
        for shape_name in shapes:
            if shape_name not in supported_shapes(cfg):
                print(f"[dryrun] SKIP {arch} x {shape_name} (DESIGN.md)")
                continue
            for mp in meshes:
                try:
                    rows.append(run_pair(arch, shape_name, multi_pod=mp,
                                         device=args.device))
                except Exception as e:                     # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shape_name, mp, repr(e)))
                if args.json:                 # after every pair
                    with open(args.json, "w") as f:
                        json.dump(rows, f, indent=1)
    print(f"\n[dryrun] {len(rows)} pairs ran, {len(failures)} failed, "
          f"{time.perf_counter() - t0:.3f} s")
    for f_ in failures:
        print("  FAIL:", f_)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
