"""The port's roofline arithmetic and op counter against the reference
and against hand counts.

  * ``model_step_flops`` equals the reference's for every (arch, shape);
  * ``Roofline.row()`` equals the reference's once the reference's
    module constants are patched to the port's H100 figures (its files
    are not edited);
  * ``CostCounter`` counts the reference's scan test
    (``tests/test_dryrun_small.py``) exactly: 16 matmuls of a [64, 64]
    input against [64, 64] weights split over an 8-rank ``"model"`` axis
    are 16 x 2 x 64^3 / 8 FLOPs per device;
  * all-gather bytes (output bytes, as the reference's ``_OP_RE``) and
    the pod-crossing (DCN) share on a (2, 2, 2) fake mesh match a hand
    count, and ``memory_peak`` matches one on a toy step.

Everything runs in this process on a ``"fake"`` process group of 8
ranks, started by a module fixture.
"""
import math

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro_torch import configs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline

PAIRS = [(a, s) for a in sorted(configs.ARCHS)
         for s in configs.supported_shapes(configs.get_config(a))]


@pytest.fixture(scope="module")
def world():
    tmesh.fake_world(8)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_model_step_flops(arch, shape_name):
    shape = configs.INPUT_SHAPES[shape_name]
    assert roofline.model_step_flops(configs.get_config(arch), shape) \
        == ref_roofline.model_step_flops(ref_get_config(arch), shape)


@pytest.mark.parametrize("case", [
    (3.1e15, 2.2e13, 4.0e11, 1.5e10, 512, 9.9e17),
    (1.0e9, 8.0e12, 0.0, 0.0, 256, 2.0e12),
    (5.0e12, 1.0e10, 9.0e12, 0.0, 256, 1.2e15),
], ids=["dcn", "memory", "ici"])
def test_roofline_row(case, monkeypatch):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "DCN_BW"):
        monkeypatch.setattr(ref_roofline, name, getattr(tmesh, name))
    flops, byts, coll, dcn, chips, model = case
    kinds = ("all-gather", "all-reduce")
    rows = []
    for mod in (ref_roofline, roofline):
        stats = mod.CollectiveStats({k: coll / 2 for k in kinds},
                                    {k: 3 for k in kinds}, dcn_bytes=dcn)
        rows.append(mod.Roofline(
            arch="a", shape="s", mesh="m", chips=chips, hlo_flops=flops,
            hlo_bytes=byts, collective_bytes=stats.total_bytes,
            collectives=stats, model_flops=model,
            per_device_hbm_peak=7.0).row())
        assert stats.ici_bytes == coll - dcn and stats.total_count == 6
    assert rows[0] == rows[1]


def test_dtype_table_covers_common_types():
    for dt, n in [(torch.bfloat16, 2), (torch.float32, 4), (torch.int32, 4),
                  (torch.bool, 1), (torch.int64, 8)]:
        assert roofline._DTYPE_BYTES[dt] == n


def test_scan_of_sharded_matmuls_counts_exactly(world):
    """The reference's scan test: x [64, 64] split P(None, "model"),
    16 weights [64, 64] split P(None, None, "model") over 8 ranks."""
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
    with FakeTensorMode() as mode:
        x = distribute_tensor(torch.zeros(64, 64), mesh, [Shard(1)],
                              src_data_rank=None)
        ws = distribute_tensor(torch.zeros(16, 64, 64), mesh, [Shard(2)],
                               src_data_rank=None)
    counter = roofline.CostCounter(fake_mode=mode)
    with counter:
        y = x
        for i in range(16):
            y = y @ ws[i]
    assert counter.flops == 16 * 2 * 64 ** 3 / 8
    assert counter.bytes > 0
    assert counter.stats.count_by_kind["all-gather"] >= 1
    assert counter.stats.dcn_bytes == 0.0


def test_all_gather_bytes_and_dcn_split(world):
    """A [8, 16] float32 tensor split over "pod" gathers across pods (the
    pod axis crosses them: 4 ranks a pod); split over "data" it gathers
    inside a pod.  Each all-gather outputs the whole 512 bytes."""
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    with FakeTensorMode() as mode:
        over_pod = distribute_tensor(torch.zeros(8, 16), mesh,
                                     [Shard(0), Replicate(), Replicate()],
                                     src_data_rank=None)
        over_data = distribute_tensor(torch.zeros(8, 16), mesh,
                                      [Replicate(), Shard(0), Replicate()],
                                      src_data_rank=None)
    counter = roofline.CostCounter(pod_size=4, fake_mode=mode)
    with counter:
        whole = (Replicate(),) * 3
        over_pod.redistribute(mesh, whole).to_local()
        over_data.redistribute(mesh, whole).to_local()
    stats = counter.stats
    assert stats.count_by_kind["all-gather"] == 2
    assert stats.bytes_by_kind["all-gather"] == 2 * 8 * 16 * 4
    assert stats.dcn_bytes == 8 * 16 * 4
    assert stats.ici_bytes == 8 * 16 * 4
    assert roofline.collective_breakdown(counter)[0]["bytes"] == 1024


def test_memory_peak_of_a_toy_step():
    """Inputs 4 KiB; the step holds a (4 KiB) and b (4 KiB) at once, then
    drops a: the peak above the inputs is 8 KiB."""
    def step(x):
        a = x * 2
        b = a + 1
        del a
        return b.sum()

    with FakeTensorMode() as mode:
        x = torch.zeros(1024)
    out, peak = roofline.memory_peak(step, (x,), fake_mode=mode)
    assert tuple(out.shape) == ()
    assert peak == 4096 + 8192
    counter = roofline.CostCounter(fake_mode=mode)
    with counter:
        roofline.memory_peak(step, (x,), fake_mode=mode)
    # mul, add (each reads 4 KiB, writes 4 KiB) and a sum (4 KiB + 4 B)
    assert counter.bytes == 2 * 8192 + 4096 + 4
    assert math.isclose(roofline.local_bytes((x, {"y": x})), 8192)
