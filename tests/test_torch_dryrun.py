"""The port's dry-run in this process: ``tests/test_dryrun_small.py``'s
cases on a (2, 2, 2) ``("pod", "data", "model")`` mesh over a fake
process group of 8 ranks, everything under ``FakeTensorMode``.

  * train steps of llama3.2-1b, deepseek-moe-16b, xlstm-350m and
    whisper-tiny (reduced configs, ``InputShape("mini", 64, 8, "train")``):
    the step runs through DTensor, counts FLOPs, bytes and collectives,
    and its gradient reductions cross the pod axis (DCN bytes > 0);
  * llama3.2-1b decode with the cache placed by ``cache_specs``;
  * internvl2-1b prefill, naive and optimized: naive holds every param
    byte on each device, optimized at most half of them;
  * xlstm-350m with its sLSTM scan as one op (``models/slstm_scan.py``):
    the train step counts what the loop counts, remat on and off, and
    prefill and train at S 1024 run in seconds;
  * hymba decode with 3 SSM heads over a ``model`` axis of 2.

The reference's own versions of these tests fail with the installed JAX (its
``with_sharding_constraint`` raises under the meshes ``jax.make_mesh``
builds), so these hold the port to its counts and placements.  A module
fixture starts the fake group and destroys it at teardown: no subprocess,
no port.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model, ssm
from repro_torch.models.config import InputShape


@pytest.fixture(scope="module")
def mesh():
    tmesh.fake_world(8)
    yield init_device_mesh("cpu", (2, 2, 2),
                           mesh_dim_names=("pod", "data", "model"))
    dist.destroy_process_group()


def param_bytes(cfg) -> int:
    """Bytes of the whole param tree of ``cfg``."""
    params = build_model(cfg, device="meta").init(0)
    out, stack = 0, [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            out += node.numel() * node.element_size()
    return out


def check_row(row, cfg, mesh):
    assert row["chips"] == 8 and row["mesh"] == "2x2x2"
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
    assert row["collective_bytes"] > 0
    assert row["hbm_peak_bytes"] >= row["args_bytes"] > 0
    assert 0 < row["param_bytes"] < param_bytes(cfg)
    assert row["bottleneck"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "xlstm-350m", "whisper-tiny"])
def test_train_step_runs_and_counts(mesh, arch):
    cfg = configs.get_config(arch).reduced()
    row = dryrun.dry_run(arch, InputShape("mini", 64, 8, "train"), mesh,
                         cfg=cfg)
    check_row(row, cfg, mesh)
    assert row["dcn_bytes"] > 0
    assert row["collective_counts"]["all-gather"] > 0
    # the matmuls of fwd + bwd alone (6 N D over 8 devices) come close
    # to the count: the attention and the loss add to it
    tokens = 8 * 64
    dense = 6 * cfg.active_param_count() * tokens / 8
    assert row["hlo_flops"] > 0.5 * dense


def test_decode_step_with_cache_sharding(mesh):
    cfg = configs.get_config("llama3.2-1b").reduced()
    shape = InputShape("mini", 64, 8, "decode")
    row = dryrun.dry_run("llama3.2-1b", shape, mesh, cfg=cfg)
    check_row(row, cfg, mesh)
    # the [L, 8, 64, 2, 32] caches split 4 ways over ("pod", "data") on
    # the batch and 2 ways over "model" on the 2 KV heads
    whole = 2 * cfg.n_layers * 8 * 64 * cfg.n_kv_heads * cfg.head_dim * 4
    cache_local = row["args_bytes"] - row["param_bytes"] - 2 * 2 * 4
    assert cache_local < whole / 4


@pytest.mark.parametrize("naive", [True, False], ids=["naive", "optimized"])
def test_naive_vs_optimized_sharding(mesh, naive, monkeypatch):
    if naive:
        monkeypatch.setenv("REPRO_NAIVE_SHARDING", "1")
    else:
        monkeypatch.delenv("REPRO_NAIVE_SHARDING", raising=False)
    cfg = configs.get_config("internvl2-1b").reduced()
    row = dryrun.dry_run("internvl2-1b", InputShape("mini", 64, 8, "prefill"),
                         mesh, cfg=cfg)
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
    whole = param_bytes(cfg)
    if naive:
        assert row["param_bytes"] == whole
    else:
        assert row["param_bytes"] * 2 <= whole
        assert row["collective_bytes"] > 0


def test_production_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        dryrun.run_pair("llama3.2-1b", "decode_32k", device="cuda")


# ---------------------------------------------------------------------------
# the sLSTM scan as one op (models/slstm_scan.py) and hymba's Mamba decode
# head per shard
# ---------------------------------------------------------------------------


KEYS = ("hlo_flops", "hlo_bytes", "collective_bytes", "collective_counts")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_dryrun_train_step_counts_the_same_as_the_loop(mesh, monkeypatch,
                                                       remat):
    """Reduced xlstm-350m's whole train step, with cfg.remat as the full
    config sets it or off: the op counts what the loop counts, peak
    within 5%."""
    cfg = dataclasses.replace(configs.get_config("xlstm-350m").reduced(),
                              remat=remat)
    shape = InputShape("mini", 64, 8, "train")
    op = dryrun.dry_run("xlstm-350m", shape, mesh, cfg=cfg)
    monkeypatch.setattr(ssm, "_slstm_scan", lambda cfg, r_h, gx:
                        ssm._slstm_loop(cfg, r_h, gx))
    loop = dryrun.dry_run("xlstm-350m", shape, mesh, cfg=cfg)
    assert {k: op[k] for k in KEYS} == {k: loop[k] for k in KEYS}
    assert abs(op["hbm_peak_bytes"] - loop["hbm_peak_bytes"]) \
        <= 0.05 * loop["hbm_peak_bytes"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_dryrun_long_scan_runs(mesh, kind):
    """S 1024 at reduced width: one op a block, not 1024 cell steps."""
    cfg = dataclasses.replace(configs.get_config("xlstm-350m").reduced(),
                              remat=True)
    row = dryrun.dry_run("xlstm-350m", InputShape("mini", 1024, 8, kind),
                         mesh, cfg=cfg)
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
    assert row["collective_bytes"] > 0
    assert row["hbm_peak_bytes"] >= row["args_bytes"] > 0
    if kind == "train":
        assert row["dcn_bytes"] > 0
        dense = 6 * cfg.active_param_count() * 8 * 1024 / 8
        assert row["hlo_flops"] > 0.5 * dense


def test_hymba_decode_with_uneven_ssm_heads(mesh):
    """3 SSM heads over a "model" axis of 2: the Mamba head runs per
    shard with the heads whole."""
    cfg = dataclasses.replace(configs.get_config("hymba-1.5b").reduced(),
                              ssm_heads=3)
    row = dryrun.dry_run("hymba-1.5b", InputShape("mini", 64, 8, "decode"),
                         mesh, cfg=cfg)
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
    assert row["collective_bytes"] > 0
    assert row["hbm_peak_bytes"] >= row["args_bytes"] > 0
