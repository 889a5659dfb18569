"""The port's sharding rules and input stand-ins against the reference's.

``repro_torch.dist.sharding`` keeps ``repro/dist/sharding.py``'s rules as
pure shape functions; here both packages get the same trees at published
width and depth and the same meshes, and every spec must be equal, key
path for key path:

  * params (the reference's ``jax.eval_shape(model.init)`` against the
    port's ``build_model(device="meta")``) and the AdamW moments;
  * batch specs of both packages' ``input_specs`` for every supported
    shape;
  * decode-cache specs, with ``seq_shard`` on and off;

on the meshes (16, 16), (2, 16, 16), (2, 2, 2) and (1, 1), naive
(``REPRO_NAIVE_SHARDING``) and not.  The reference reads only a mesh's
``axis_names`` and ``devices.shape``, the port only its
``mesh_dim_names`` and ``shape``, so both get a stand-in with those
attributes.  ``input_specs``, ``cache_slots`` and ``supported_shapes`` are
equal for every (arch, shape) pair.  The placements of a spec, the fake
world and the production meshes are checked on their own.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec
from torch.distributed.tensor import Replicate, Shard

from repro.configs import cache_slots as ref_cache_slots
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.configs import supported_shapes as ref_supported_shapes
from repro.dist import sharding as ref_shd
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models.layers import KVCache
from repro_torch.optim import adamw

ARCHS = sorted(configs.ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
PAIRS = [(a, s) for a in ARCHS
         for s in configs.supported_shapes(configs.get_config(a))]
KV_FIELDS = ("k", "v", "pos", "k_scale", "v_scale")


def meshes(name):
    """(reference stand-in, port stand-in) of one mesh."""
    shape, axes = MESHES[name]
    return (types.SimpleNamespace(axis_names=axes, devices=np.empty(shape)),
            types.SimpleNamespace(mesh_dim_names=axes, shape=shape))


def ref_flat(tree) -> dict:
    """path -> spec tuple of a reference spec tree (a KVCache's children
    named by field)."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        key = tuple(KV_FIELDS[p.key]
                    if isinstance(p, jax.tree_util.FlattenedIndexKey)
                    else str(p.key) for p in path)
        out[key] = tuple(spec)
    return out


def port_flat(tree, prefix=()) -> dict:
    """path -> spec tuple of a port spec tree."""
    if isinstance(tree, shd.P):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in port_flat(tree[key], prefix + (key,)).items()}
    assert isinstance(tree, KVCache), type(tree)
    return {k: v for f in KV_FIELDS if getattr(tree, f) is not None
            for k, v in port_flat(getattr(tree, f), prefix + (f,)).items()}


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(reference params, port params, reference moments, port moments),
    shapes only, at published width and depth."""
    rm = ref_build_model(ref_get_config(arch))
    rp = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
    ro = jax.eval_shape(functools.partial(ref_adamw.init,
                                          ref_adamw.AdamWConfig()), rp)
    pp = build_model(configs.get_config(arch), device="meta").init(0)
    po = adamw.init(adamw.AdamWConfig(), pp)
    return rp, pp, ro, po


@functools.lru_cache(maxsize=None)
def caches(arch, shape_name):
    """(reference cache, port cache) of a decode shape, shapes only."""
    shape = configs.INPUT_SHAPES[shape_name]
    cfg = configs.get_config(arch)
    B, slots = shape.global_batch, configs.cache_slots(cfg, shape)
    rm = ref_build_model(ref_get_config(arch),
                         max_seq=min(shape.seq_len, 65536))
    rc = jax.eval_shape(lambda: rm.init_cache(B, slots))
    pc = build_model(cfg, max_seq=min(shape.seq_len, 65536),
                     device="meta").init_cache(B, slots)
    return rc, pc


@pytest.fixture(params=[False, True], ids=["sharded", "naive"])
def naive(request, monkeypatch):
    if request.param:
        monkeypatch.setenv("REPRO_NAIVE_SHARDING", "1")
    else:
        monkeypatch.delenv("REPRO_NAIVE_SHARDING", raising=False)
    return request.param


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs(arch, mesh, naive):
    rmesh, pmesh = meshes(mesh)
    rp, pp, ro, po = trees(arch)
    want = ref_flat(ref_shd.param_specs(rp, rmesh))
    got = port_flat(shd.param_specs(pp, pmesh))
    assert got == want
    want = ref_flat(ref_shd.param_specs(ro, rmesh))
    got = port_flat(shd.param_specs(po, pmesh))
    assert got == want
    if naive:
        assert all(s == () for s in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs(arch, mesh):
    rmesh, pmesh = meshes(mesh)
    cfg = configs.get_config(arch)
    for name in configs.supported_shapes(cfg):
        shape = configs.INPUT_SHAPES[name]
        want = ref_flat(ref_shd.batch_specs(
            ref_input_specs(ref_get_config(arch), shape), rmesh))
        got = port_flat(shd.batch_specs(configs.input_specs(cfg, shape),
                                        pmesh))
        assert got == want, name


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs(arch, mesh, seq_shard, naive):
    rmesh, pmesh = meshes(mesh)
    names = [s for s in configs.supported_shapes(configs.get_config(arch))
             if configs.INPUT_SHAPES[s].is_decode]
    for name in names:
        rc, pc = caches(arch, name)
        want = ref_flat(ref_shd.cache_specs(rc, rmesh, seq_shard=seq_shard))
        got = port_flat(shd.cache_specs(pc, pmesh, seq_shard=seq_shard))
        assert got == want, name


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_input_specs_and_shape_rules(arch, shape_name):
    cfg, rcfg = configs.get_config(arch), ref_get_config(arch)
    shape = configs.INPUT_SHAPES[shape_name]
    assert configs.supported_shapes(cfg) == ref_supported_shapes(rcfg)
    assert configs.cache_slots(cfg, shape) == ref_cache_slots(rcfg, shape)
    for batch in (None, 3):
        want = ref_input_specs(rcfg, shape, batch_override=batch)
        got = configs.input_specs(cfg, shape, batch_override=batch)
        assert sorted(got) == sorted(want)
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[key].shape), key
            assert str(spec.dtype).removeprefix("torch.") \
                == str(want[key].dtype), key


def test_placements_of_a_spec():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 2, 2))
    assert shd.placements(shd.P(("pod", "data"), None), mesh) == (
        Shard(0), Shard(0), Replicate())
    assert shd.placements(shd.P(None, "model", "data"), mesh) == (
        Replicate(), Shard(2), Shard(1))
    assert shd.placements(shd.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        shd.placements(shd.P(("data", "pod")), mesh)


def test_fake_world_and_production_meshes():
    try:
        tmesh.fake_world(4)
        assert dist.get_world_size() == 4 and dist.get_backend() == "fake"
        single = tmesh.make_production_mesh(device="cpu")
        assert dist.get_world_size() == 256
        assert single.mesh_dim_names == ("data", "model")
        assert tuple(single.shape) == (16, 16)
        multi = tmesh.make_production_mesh(multi_pod=True, device="cpu")
        assert tuple(multi.shape) == (2, 16, 16)
        assert multi.mesh_dim_names == ("pod", "data", "model")
        host = tmesh.make_host_mesh(2, 4, device="cpu")
        assert tuple(host.shape) == (2, 4) and dist.get_world_size() == 8
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                tmesh.make_production_mesh(device="cuda")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
