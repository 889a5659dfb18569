"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: every test asks the ``cuda`` fixture for the card and
skips where there is none.  The file imports neither JAX nor the
reference, so it runs on a machine with the card but no JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Inputs are made from numpy seeds.  The scheduler kernels (K1-K4) are
held ``torch.equal`` to their plain versions (float64, bit for bit); the
attention kernel K5, the RMSNorm kernel K7 and the SwiGLU kernel K8
within 2e-5 in float32 and 2e-2 in bfloat16, the mLSTM kernel K6 within
2e-4 and 3e-2, the tolerances of the reference's kernel tests (fp32 sums
in another order).  The scheduler service on the card (every decision
priced by K1/K2) is held bit for bit against the same service on the
CPU: drains, journals, run_online, recovery of a cut sqlite journal, and
the module-wide tau switch left unset between steps, and gadget-elastic's
resize.  The production-mesh dry-run runs one full-width pair on fake CUDA
tensors, and counts the same FLOPs and collectives on fake and real
tensors on one real rank; the sLSTM scan op counts what its loop counts
on fake CUDA tensors.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import philly_cluster, philly_workload
from repro_torch.core.cluster import Cluster
from repro_torch.core.contention import _job_terms
from repro_torch.kernels import LAUNCHES, ops, placement, tau
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm as ml
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import swiglu as sg

HETERO = dict(speed_tiers=((50.0, 0.5), (12.5, 0.5)),
              link_classes=((1.25, "shared", 0.5), (1.25, "isolated", 0.5)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False    # full fp32 references
    return torch.device("cuda")


def _on(dev, a, dtype):
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def _cluster(seed, hetero):
    return philly_cluster(6, seed=seed, **(HETERO if hetero else {}))


def _stack(cluster, jobs, rng, n_cands, terms_2d):
    """A random candidate stack; with ``terms_2d`` each candidate holds
    its own row order plus zero padding rows, as the columnar engine's
    branch stacks do."""
    S, N = cluster.num_servers, cluster.num_gpus
    G, share, compute = _job_terms(jobs)
    J = len(jobs) + (3 if terms_2d else 0)
    Y = np.zeros((n_cands, J, S), dtype=np.int64)
    G2 = np.zeros((n_cands, J), dtype=np.int64)
    sh2, cp2 = np.zeros((n_cands, J)), np.ones((n_cands, J))
    for c in range(n_cands):
        perm = rng.permutation(len(jobs)) if terms_2d \
            else np.arange(len(jobs))
        for r, j in enumerate(perm):
            gpus = rng.choice(N, size=G[j], replace=False)
            Y[c, r] = np.bincount(cluster.gpu_server[gpus], minlength=S)
        G2[c, :len(jobs)], sh2[c, :len(jobs)], cp2[c, :len(jobs)] = \
            G[perm], share[perm], compute[perm]
    if terms_2d:
        return Y, G2, sh2, cp2
    return Y, G, share, compute


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("terms_2d", [False, True])
def test_tau_kernel_equals_plain(cuda, hetero, terms_2d):
    cluster = _cluster(2, hetero)
    jobs = philly_workload(seed=2, mix=((1, 8), (2, 4), (4, 4), (8, 2),
                                        (16, 1)))
    Y, G, share, compute = _stack(cluster, jobs, np.random.default_rng(9),
                                  64, terms_2d)
    args = (_on(cuda, Y, torch.int64), _on(cuda, G, torch.int64),
            _on(cuda, share, torch.float64), _on(cuda, compute, torch.float64))
    kw = dict(xi1=cluster.xi1, xi2=cluster.xi2, alpha=cluster.alpha,
              b_intra=cluster.b_intra)
    name = "tau_het" if hetero else "tau"
    before = LAUNCHES[name]
    if hetero:
        ct = tau.cluster_tensors(cluster, cuda)
        dev_terms = (ct["speed_floor"], ct["uplink_sh"], ct["uplink_iso"])
        got = tau.tau_stack_het(*args, *dev_terms, **kw)
        want = tau.tau_stack_het_plain(*args, *dev_terms, **kw)
    else:
        kw.update(b_inter=cluster.b_inter, gpu_speed=cluster.gpu_speed)
        got = tau.tau_stack_hom(*args, **kw)
        want = tau.tau_stack_hom_plain(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _random_stack(rng, dev, C, J, S, terms_2d):
    """A random [C, J, S] stack with occupied, straddled and whole
    entries, [J] or [C, J] terms and per-server K2 terms (+inf where a
    class is absent)."""
    Y = rng.integers(1, 5, (C, J, S)) * (rng.random((C, J, S)) < 0.15)
    shape = (C, J) if terms_2d else (J,)
    G = rng.integers(1, 6, shape)
    share, compute = rng.uniform(0.1, 10.0, shape), rng.uniform(1, 5, shape)
    server = [rng.uniform(0.5, 50.0, S) for _ in range(3)]
    for t in server[1:]:
        t[rng.random(S) < 0.3] = np.inf
    return ((_on(dev, Y, torch.int64), _on(dev, G, torch.int64),
             _on(dev, share, torch.float64), _on(dev, compute, torch.float64)),
            tuple(_on(dev, t, torch.float64) for t in server))


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("terms_2d", [False, True])
@pytest.mark.parametrize("C,J,S", [
    (16, 1025, 32),     # the |J| = 1024 scale point's stack rows and servers
    (8, 2500, 20),      # beyond the 48 KB of shared memory: taken in chunks
    (4, 3, 300),        # more servers than threads: the staging loops wrap
])
def test_tau_kernel_equals_plain_at_scale(cuda, hetero, terms_2d, C, J, S):
    args, server = _random_stack(np.random.default_rng(C + J + S), cuda, C, J,
                                 S, terms_2d)
    kw = dict(xi1=0.3, xi2=0.01, alpha=0.7, b_intra=50.0)
    if hetero:
        got = tau.tau_stack_het(*args, *server, **kw)
        want = tau.tau_stack_het_plain(*args, *server, **kw)
    else:
        kw.update(b_inter=1.25, gpu_speed=25.0)
        got = tau.tau_stack_hom(*args, **kw)
        want = tau.tau_stack_hom_plain(*args, **kw)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _pool_args(dev, cluster, nw, G, pid, rng):
    """K3 operands over ``nw`` random work rows of ``cluster``: idle GPUs
    (exact-tie clocks), thetas from nearly empty to every GPU feasible,
    lambda * G = 1.5 G."""
    N = cluster.num_gpus
    U = np.round(rng.uniform(0, 400, size=(nw, N)), 3)
    U[:, rng.random(N) < 0.3] = 0.0
    th_lo = rng.uniform(0, 700, size=nw)
    th_lo[::5] = 1e4
    ct = tau.cluster_tensors(cluster, dev)
    return (_on(dev, U, torch.float64), _on(dev, th_lo, torch.float64),
            _on(dev, th_lo + rng.uniform(0, 50, size=nw), torch.float64),
            _on(dev, rng.uniform(5, 150, size=nw), torch.float64),
            _on(dev, pid, torch.int64), G, 1.5 * G, ct["offsets"],
            ct["caps"], _on(dev, cluster.gpu_server, torch.int64))


def _pool_equal(args):
    before = LAUNCHES["pool"]
    got = placement.pool_stats(*args)
    want = placement.pool_stats_plain(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["pool"] == before + 1
    names = ("c_lo", "c_hi", "load", "cnt", "best_srv", "has_fit", "order",
             "ok")
    for name, w, g in zip(names, want, got):
        assert w.dtype == g.dtype, name
        assert torch.equal(w, g), name


@pytest.mark.parametrize("G", [1, 4, 16, 64])
def test_pool_kernel_equals_plain(cuda, G):
    cluster = _cluster(5, hetero=False)
    rng = np.random.default_rng(3)
    _pool_equal(_pool_args(cuda, cluster, 64, G, rng.integers(0, 2, 64),
                           rng))


def _wide_cluster(width):
    """The §7 and scale-point clusters, a synthetic row wider than the
    block and one shared-memory pass (2600 GPUs), and one whose 1002
    servers need shared memory beyond the default 48 KB."""
    if width == "s7":
        return philly_cluster(20, seed=1)
    if width == "scale":
        return philly_cluster(32, seed=1)
    if width == "wide":
        return Cluster(capacities=(8,) * 325)
    return Cluster(capacities=(2, 3, 4) * 334)


@pytest.mark.parametrize("picker", ["fa_ffp", "lbsgf", "mixed"])
@pytest.mark.parametrize("G", ["1", "8", "N"])
@pytest.mark.parametrize("nw", [1, 64, 300])
@pytest.mark.parametrize("width", ["s7", "scale", "wide", "many_servers"])
def test_pool_kernel_equals_plain_at_widths(cuda, width, nw, G, picker):
    cluster = _wide_cluster(width)
    rng = np.random.default_rng(nw + cluster.num_gpus)
    g = cluster.num_gpus if G == "N" else int(G)
    pid = {"fa_ffp": np.zeros(nw, dtype=np.int64),
           "lbsgf": np.ones(nw, dtype=np.int64),
           "mixed": rng.integers(0, 2, nw)}[picker]
    _pool_equal(_pool_args(cuda, cluster, nw, g, pid, rng))


def _score_args(dev, S, C, hetero, rng):
    """K4 operands: C random occupancy rows over S servers (some on one
    server only), contention levels from 0 up, per-server device terms
    (+inf where a class is absent) and the kernel's keyword scalars."""
    Y = rng.integers(0, 4, size=(C, S)) * (rng.random((C, S)) < 0.3)
    Y[::4] = 0
    Y[::4, rng.integers(S)] = 8
    Y[Y.sum(axis=1) == 0, 0] = 1
    p = np.floor(rng.uniform(0, 9, size=C))
    server = [rng.uniform(0.5, 50.0, S) for _ in range(3)]
    for t in server[1:]:
        t[rng.random(S) < 0.3] = np.inf
    args = (_on(dev, Y, torch.int64), _on(dev, p, torch.float64),
            *(_on(dev, t, torch.float64) for t in server),
            (0.002, 0.001, 0.001 / 50.0, 0.02, 3000.0))
    kw = dict(hetero=hetero, xi1=0.7, xi2=0.002, alpha=0.3, b_inter=1.25,
              b_intra=300.0)
    return args, kw


def _score_equal(args, kw):
    before = LAUNCHES["score"]
    got = placement.score_rows(*args, **kw)
    want = placement.score_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["score"] == before + 1
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("hetero", [False, True])
def test_score_kernel_equals_plain(cuda, hetero):
    cluster = _cluster(7, hetero)
    S = cluster.num_servers
    rng = np.random.default_rng(4)
    Y = rng.integers(0, 3, size=(64, S))
    Y[Y.sum(axis=1) == 0, 0] = 1
    p = rng.integers(0, 8, size=64).astype(np.float64)
    ct = tau.cluster_tensors(cluster, cuda)
    args = (_on(cuda, Y, torch.int64), _on(cuda, p, torch.float64),
            ct["speed_floor"], ct["uplink_sh"], ct["uplink_iso"],
            (0.002, 0.001, 0.001 / 50.0, 0.02, 3000.0))
    kw = dict(hetero=hetero, xi1=cluster.xi1, xi2=cluster.xi2,
              alpha=cluster.alpha, b_inter=cluster.b_inter,
              b_intra=cluster.b_intra)
    _score_equal(args, kw)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("C", [1, 64, 1000])
@pytest.mark.parametrize("S", [20, 32, 300])
def test_score_kernel_equals_plain_at_shapes(cuda, S, C, hetero):
    """S = 300: more servers than a warp's lanes, each lane strides."""
    _score_equal(*_score_args(cuda, S, C, hetero,
                              np.random.default_rng(S + C)))


def _pick_case(rng, N, nw):
    U = np.round(rng.uniform(0, 400, size=(nw, N)), 3)
    U[:, rng.random(N) < 0.3] = 0.0
    th_lo = rng.uniform(100, 700, size=nw)
    return (U, th_lo, th_lo + rng.uniform(0, 50, size=nw),
            rng.uniform(5, 150, size=nw), rng.integers(0, 2, nw))


def test_pick_orders_reuses_pinned_buffers(cuda):
    """Back-to-back entry-point calls of 64, 8 and 300 rows (the last
    grows the pinned buffers): each equals the CPU path, and a result is
    not overwritten by the calls after it."""
    cluster = philly_cluster(20, seed=1)
    job = philly_workload(seed=1)[7]
    rng = np.random.default_rng(12)
    cases = [_pick_case(rng, cluster.num_gpus, nw) for nw in (64, 8, 300)]
    before = LAUNCHES["pool"]
    got = [placement.pick_orders(cluster, *c, job) for c in cases]
    kept = [a.copy() for a in got[0]]
    assert LAUNCHES["pool"] == before + 3
    for case, res in zip(cases, got):
        want = placement.pick_orders(cluster, *case, job, device="cpu")
        for w, g in zip(want, res):
            assert w.dtype == g.dtype and np.array_equal(w, g)
    for k, g in zip(kept, got[0]):
        assert np.array_equal(k, g)


@pytest.mark.parametrize("hetero", [False, True])
def test_score_probes_reuses_pinned_buffers(cuda, hetero):
    cluster = philly_cluster(20, seed=1, **(HETERO if hetero else {}))
    jobs = philly_workload(seed=1)
    S = cluster.num_servers
    rng = np.random.default_rng(13)
    before = LAUNCHES["score"]
    for i, C in enumerate((64, 8, 300)):
        Y = rng.integers(0, 3, size=(C, S)) * (rng.random((C, S)) < 0.3)
        Y[Y.sum(axis=1) == 0, 0] = 1
        p = np.floor(rng.uniform(0, 9, size=C))
        got = placement.score_probes(cluster, jobs[i], Y, p)
        want = placement.score_probes(cluster, jobs[i], Y, p, device="cpu")
        for w, g in zip(want, got):
            assert np.array_equal(w, g)
    assert LAUNCHES["score"] == before + 3


def _tau_equal(cluster, G, share, compute, Y):
    """``tau_stack`` on the card (one C call over the pinned staging)
    against the tensor wrappers on the card, ``tau_stack`` on the CPU (the
    plain versions) and the NumPy ``stack_model``, bit for bit; one launch
    counted for a non-empty stack, none for an empty one.  Returns the
    card's arrays."""
    from repro_torch.core.contention import stack_model
    name = "tau_het" if cluster.is_heterogeneous else "tau"
    before = LAUNCHES[name]
    got = tau.tau_stack(cluster, G, share, compute, Y)
    C, J, _ = Y.shape
    assert LAUNCHES[name] == before + (1 if C and J else 0)
    want = tau.tau_stack(cluster, G, share, compute, Y, device="cpu")
    for w, g, dtype in zip(want, got, (np.int64, np.int64, np.float64)):
        assert g.dtype == dtype and g.shape == (C, J)
        assert np.array_equal(w, g)
    model = stack_model(cluster, G, share, compute, Y)
    assert np.array_equal(model.p, got[0])
    assert np.array_equal((Y > 0).sum(axis=2), got[1])
    assert np.array_equal(model.tau, got[2])
    if C and J:
        dev = torch.device("cuda")
        args = (_on(dev, Y, torch.int64), _on(dev, G, torch.int64),
                _on(dev, share, torch.float64),
                _on(dev, compute, torch.float64))
        kw = dict(xi1=cluster.xi1, xi2=cluster.xi2, alpha=cluster.alpha,
                  b_intra=cluster.b_intra)
        if cluster.is_heterogeneous:
            ct = tau.cluster_tensors(cluster, dev)
            ref = tau.tau_stack_het(*args, ct["speed_floor"], ct["uplink_sh"],
                                    ct["uplink_iso"], **kw)
        else:
            ref = tau.tau_stack_hom(*args, b_inter=cluster.b_inter,
                                    gpu_speed=cluster.gpu_speed, **kw)
        for r, g in zip(ref, got):
            assert np.array_equal(r.cpu().numpy(), g)
    return got


def _numpy_stack(rng, cluster, C, J, terms_2d):
    """A random [C, J, S] stack on ``cluster``'s servers with occupied,
    straddled and whole entries and [J] or [C, J] terms."""
    S = cluster.num_servers
    Y = rng.integers(1, 5, (C, J, S)) * (rng.random((C, J, S)) < 0.15)
    shape = (C, J) if terms_2d else (J,)
    return (rng.integers(1, 6, shape), rng.uniform(0.1, 10.0, shape),
            rng.uniform(1, 5, shape), Y)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("terms_2d", [False, True])
def test_tau_stack_round_trip_equals_wrappers_and_numpy(cuda, hetero,
                                                        terms_2d):
    cluster = _cluster(2, hetero)
    jobs = philly_workload(seed=2, mix=((1, 8), (2, 4), (4, 4), (8, 2),
                                        (16, 1)))
    Y, G, share, compute = _stack(cluster, jobs, np.random.default_rng(9),
                                  64, terms_2d)
    _tau_equal(cluster, G, share, compute, Y)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("terms_2d", [False, True])
def test_tau_stack_reuses_staging_with_a_stale_tail(cuda, hetero, terms_2d):
    """Growing then shrinking stacks, so later calls read buffers whose
    tail holds an earlier, larger stack; the chunked shapes (J = 1025 and
    2500 rows) among them.  A result is not overwritten by the calls
    after it."""
    rng = np.random.default_rng(21 + 2 * hetero + terms_2d)
    cluster = philly_cluster(32, seed=1, **(HETERO if hetero else {}))
    shapes = [(2, 5), (64, 161), (16, 1025), (4, 3), (1, 1), (8, 2500),
              (3, 40), (64, 161), (2, 7)]
    results = []
    for C, J in shapes:
        case = _numpy_stack(rng, cluster, C, J, terms_2d)
        got = _tau_equal(cluster, *case)
        results.append(([a.copy() for a in got], got))
    for kept, got in results:
        for k, g in zip(kept, got):
            assert np.array_equal(k, g)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("C,J", [(0, 5), (4, 0), (0, 0)])
def test_tau_stack_empty_stacks_launch_nothing(cuda, hetero, C, J):
    cluster = _cluster(3, hetero)
    for terms_2d in (False, True):
        case = _numpy_stack(np.random.default_rng(C + J), cluster, C, J,
                            terms_2d)
        _tau_equal(cluster, *case)


def test_tau_stack_interleaved_with_pick_orders(cuda):
    """tau_stack and pick_orders called in turn, each over its own pinned
    staging: every result equals the CPU path's."""
    cluster = philly_cluster(20, seed=1)
    job = philly_workload(seed=1)[7]
    rng = np.random.default_rng(22)
    before = dict(LAUNCHES)
    for i, (C, J, nw) in enumerate([(64, 161, 64), (1, 9, 8), (8, 300, 300),
                                    (64, 161, 3)]):
        stack = _numpy_stack(rng, cluster, C, J, terms_2d=bool(i % 2))
        _tau_equal(cluster, *stack)
        case = _pick_case(rng, cluster.num_gpus, nw)
        got = placement.pick_orders(cluster, *case, job)
        want = placement.pick_orders(cluster, *case, job, device="cpu")
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and np.array_equal(w, g)
    assert LAUNCHES["pool"] == before["pool"] + 4


def test_cuda_tensor_never_takes_the_plain_path(cuda):
    """A CUDA tensor launches the kernel (counted) or raises."""
    bad = torch.zeros((2, 3), dtype=torch.float32, device=cuda)
    f64 = torch.zeros(2, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        placement.pool_stats(bad, f64, f64, f64,
                             torch.zeros(2, dtype=torch.int64, device=cuda),
                             1, 1.0,
                             torch.zeros(1, dtype=torch.int64, device=cuda),
                             torch.ones(1, dtype=torch.int64, device=cuda),
                             torch.zeros(3, dtype=torch.int64, device=cuda))


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _qkv(dev, dtype, B, H, K, Sq, Skv, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def t(n, S):
        a = rng.standard_normal((B, n, S, hd)).astype(np.float32) * scale
        return torch.tensor(a, device=dev).to(dtype)

    return t(H, Sq), t(K, Skv), t(K, Skv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,hd", [
    (1, 2, 2, 128, 32), (2, 8, 2, 200, 64), (1, 4, 1, 320, 128),
])
def test_flash_kernel_close_to_plain(cuda, B, H, K, S, hd, dtype):
    q, k, v = _qkv(cuda, dtype, B, H, K, S, S, hd, seed=S + hd)
    before = LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(window=32), dict(window=300), dict(softcap=50.0, scale=3.0),
    dict(causal=False, Sq=128, Skv=256), dict(kv_len=150, Skv=192),
    dict(causal=False, kv_len=70, Sq=64, Skv=100), dict(hd=256, Sq=96),
    dict(hd=32),
])
def test_flash_kernel_options(cuda, case, dtype):
    case = dict(case)
    causal = case.pop("causal", True)
    hd, Sq = case.pop("hd", 64), case.pop("Sq", 256)
    Skv = case.pop("Skv", Sq)
    q, k, v = _qkv(cuda, dtype, 2, 4, 2, Sq, Skv, hd, seed=7,
                   scale=case.pop("scale", 1.0))
    got = fa.flash_attention(q, k, v, causal=causal, **case)
    want = fa.flash_attention_plain(q, k, v, causal=causal, **case)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_flash_bf16_fully_masked_rows_give_zero(cuda):
    """window 16 over kv_len 150 of 192: rows 165 and beyond see no kv
    position, and the kernel writes 0 there, as the plain version does."""
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 4, 4, 192, 192, 64, seed=8)
    got = fa.flash_attention(q, k, v, window=16, kv_len=150)
    want = fa.flash_attention_plain(q, k, v, window=16, kv_len=150)
    assert bool((got[:, :, 165:] == 0).all())
    assert bool(got[:, :, :165].abs().amax(dim=-1).gt(0).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


def test_flash_bf16_reads_misaligned_views(cuda):
    """A bf16 q whose base sits one element past 16 bytes (rows 65
    elements apart) goes to the kernel as a contiguous copy: the result
    equals that of the copy bit for bit and the plain version's within
    2e-2."""
    q, k, v = _qkv(cuda, torch.bfloat16, 2, 4, 2, 200, 200, 64, seed=10)
    wide = torch.zeros(2, 4, 200, 65, dtype=torch.bfloat16, device=cuda)
    wide[..., 1:] = q
    view = wide[..., 1:]
    assert view.data_ptr() % 16 != 0
    before = LAUNCHES["flash_attention"]
    got = fa.flash_attention(view, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert torch.equal(got, fa.flash_attention(q, k, v))
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               **_tol(torch.bfloat16))


def test_flash_model_layout_reads_strided_views(cuda):
    """ops.flash_attention hands the kernel transposed [B,S,H,hd] views."""
    rng = np.random.default_rng(11)
    B, S, H, K, hd = 2, 200, 8, 2, 64
    q, k, v = (torch.tensor(rng.standard_normal((B, S, n, hd)),
                            dtype=torch.float32, device=cuda)
               for n in (H, K, K))
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    assert got.shape == (B, S, H, hd) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_cuda_tensor_never_takes_the_plain_path(cuda, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 2, 1, 128, 128, 64, seed=3)
    before = LAUNCHES["flash_attention"]
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*(t[..., :48] for t in (q, k, v)))
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())


def _mlstm_inputs(dev, dtype, BH, S, hd, seed):
    """q, k (pre-scaled), v [BH, S, hd] in ``dtype``; F, i [BH, S] float32,
    with the reference test's gate distributions."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BH, S, hd)) for _ in range(3))
    k = k / np.sqrt(hd)
    F = np.cumsum(-np.logaddexp(0.0, -(3.0 + rng.standard_normal((BH, S)))),
                  axis=1)
    i = rng.standard_normal((BH, S))
    return ([_on(dev, a, torch.float32).to(dtype) for a in (q, k, v)]
            + [_on(dev, a, torch.float32) for a in (F, i)])


def _mlstm_tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,hd", [
    (2, 128, 64), (1, 300, 128), (3, 200, 256), (2, 256, 512), (1, 20, 32),
])
def test_mlstm_kernel_close_to_plain(cuda, BH, S, hd, dtype):
    args = _mlstm_inputs(cuda, dtype, BH, S, hd, seed=S + hd)
    before = LAUNCHES["mlstm"]
    got = ml.mlstm_parallel(*args)
    want = ml.mlstm_parallel_plain(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_mlstm_tol(dtype))


def test_mlstm_model_layout_reads_strided_views(cuda):
    """ops.mlstm hands the kernel transposed views of q/k/v split out of
    one [B, S, 3*H*hd] product and of F/i split out of [B, S, 2H]."""
    rng = np.random.default_rng(12)
    B, S, H, hd = 2, 160, 4, 64
    qkv = _on(cuda, rng.standard_normal((B, S, 3 * H * hd)), torch.float32)
    q, k, v = (t.reshape(B, S, H, hd) for t in qkv.chunk(3, dim=-1))
    v = v / 8.0
    gates = _on(cuda, rng.standard_normal((B, S, 2 * H)), torch.float32)
    i, f = gates.chunk(2, dim=-1)
    F = torch.cumsum(torch.nn.functional.logsigmoid(f + 3.0), dim=1)
    got = ops.mlstm(q, k, v, F, i)
    want = ml.mlstm_parallel_plain(
        *(t.transpose(1, 2) for t in (q, k, v, F, i))).transpose(1, 2)
    assert got.shape == (B, S, H, hd) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_mlstm_cuda_tensor_never_takes_the_plain_path(cuda, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(ml, "mlstm_parallel_plain", refuse)
    q, k, v, F, i = _mlstm_inputs(cuda, torch.float32, 2, 64, 64, seed=4)
    before = LAUNCHES["mlstm"]
    ml.mlstm_parallel(q, k, v, F, i)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm"] == before + 1
    with pytest.raises(ValueError, match="head dim"):
        ml.mlstm_parallel(*(t[..., :48] for t in (q, k, v)), F, i)
    with pytest.raises(TypeError, match="F: dtype"):
        ml.mlstm_parallel(q, k, v, F.bfloat16(), i)


def test_xlstm_prefill_kernel_on_vs_off(cuda):
    """The reduced xlstm-350m on the card: K6 launches once per mLSTM
    block and agrees with the query-chunked path within 2e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(),
                              use_flash_kernel=True)
    on = build_model(cfg, device=cuda)
    off = build_model(dataclasses.replace(cfg, use_flash_kernel=False),
                      device=cuda)
    params = on.init(0)
    toks = _on(cuda, np.random.default_rng(1).integers(0, cfg.vocab,
                                                       (2, 64)), torch.int32)
    before = LAUNCHES["mlstm"]
    got = on.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm"] == before + 2       # 2 groups x 1 mLSTM block
    want = off.prefill(params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernel_reads_unaligned_views(cuda, dtype):
    """Rows that do not start on 16 bytes go to the kernel as float32
    copies (its cp.async copies need aligned rows); the result is the
    same."""
    q, k, v, F, i = _mlstm_inputs(cuda, dtype, 2, 150, 64, seed=9)
    wide = [torch.zeros(2, 150, 65, dtype=dtype, device=cuda)
            for _ in range(3)]
    for w, t in zip(wide, (q, k, v)):
        w[..., 1:] = t
    views = [w[..., 1:] for w in wide]
    got = ml.mlstm_parallel(*views, F, i)
    want = ml.mlstm_parallel(q, k, v, F, i)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _mlstm_close(got, args, tol=2e-4):
    want = ml.mlstm_parallel_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 1000, 1024])
def test_mlstm_kernel_tile_edges(cuda, S):
    """S at the edges of the kernel's tiles (query tiles of 64 rows, warp
    row groups of 8, kv tiles of 64 and their 8-row v stages) at
    xlstm-350m's head dim 512."""
    args = _mlstm_inputs(cuda, torch.float32, 2, S, 512, seed=S)
    _mlstm_close(ml.mlstm_parallel(*args), args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ml.HEAD_DIMS)
def test_mlstm_kernel_each_head_dim(cuda, hd, dtype):
    """Every head dim the kernel is built for (k stages of min(hd, 64)
    columns), at a ragged S."""
    args = _mlstm_inputs(cuda, dtype, 2, 300, hd, seed=hd)
    _mlstm_close(ml.mlstm_parallel(*args), args, _mlstm_tol(dtype)["atol"])


@pytest.mark.parametrize("BH", [1, 16])
def test_mlstm_kernel_batch_heads(cuda, BH):
    """One (batch, head) and sixteen, the xlstm-350m prefill's B * H."""
    args = _mlstm_inputs(cuda, torch.float32, BH, 320, 512, seed=BH)
    _mlstm_close(ml.mlstm_parallel(*args), args)


def test_mlstm_model_layout_views_at_head_dim_512(cuda):
    """ops.mlstm at xlstm-350m's head dim: q/k/v transposed views of one
    [B, S, 3*H*hd] product (rows 3*H*hd apart), F/i of one [B, S, 2H]."""
    rng = np.random.default_rng(13)
    B, S, H, hd = 2, 200, 4, 512
    qkv = _on(cuda, rng.standard_normal((B, S, 3 * H * hd)), torch.float32)
    q, k, v = (t.reshape(B, S, H, hd) for t in qkv.chunk(3, dim=-1))
    v = v / hd ** 0.5
    gates = _on(cuda, rng.standard_normal((B, S, 2 * H)), torch.float32)
    i, f = gates.chunk(2, dim=-1)
    F = torch.cumsum(torch.nn.functional.logsigmoid(f + 3.0), dim=1)
    got = ops.mlstm(q, k, v, F, i)
    want = ml.mlstm_parallel_plain(
        *(t.transpose(1, 2) for t in (q, k, v, F, i))).transpose(1, 2)
    torch.cuda.synchronize()
    assert got.shape == (B, S, H, hd) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_mlstm_copies_only_operands_without_16_byte_rows(cuda, monkeypatch):
    """The wrapper copies q, k or v only where the kernel cannot read it:
    model-layout views are read in place; a view one element off its
    allocation and bfloat16 operands go in as float32 copies."""
    copied = []
    kernel_operand = ml._kernel_operand

    def spy(t):
        out = kernel_operand(t)
        copied.append(out.data_ptr() != t.data_ptr())
        return out

    monkeypatch.setattr(ml, "_kernel_operand", spy)
    rng = np.random.default_rng(14)
    B, S, H, hd = 2, 96, 2, 128
    qkv = _on(cuda, rng.standard_normal((B, S, 3 * H * hd + 4)),
              torch.float32)
    gates = _on(cuda, rng.standard_normal((B, H, 2, S)), torch.float32)
    F = torch.cumsum(torch.nn.functional.logsigmoid(gates[:, :, 0] + 3.0),
                     dim=-1)
    i = gates[:, :, 1]
    aligned = [t.reshape(B, S, H, hd).transpose(1, 2)
               for t in qkv[..., :-4].chunk(3, dim=-1)]
    off = [t.reshape(B, S, H, hd).transpose(1, 2)
           for t in qkv[..., 1:-3].chunk(3, dim=-1)]
    for q, k, v, want_copy in (
            (*aligned, [False] * 3), (off[0], *aligned[1:], [True, False,
                                                             False]),
            (*(t.bfloat16() for t in aligned), [True] * 3)):
        copied.clear()
        got = ml.mlstm_parallel(q, k, v, F, i)
        assert copied == want_copy
        _mlstm_close(got, (q, k, v, F, i), _mlstm_tol(q.dtype)["atol"])


@pytest.mark.parametrize("hd", ml.HEAD_DIMS)
def test_mlstm_kernel_is_deterministic(cuda, hd):
    """The same values give the same bits: on the first launch after other
    inputs, again, and read from copies at other addresses (no shared
    memory is read before the block has written it)."""
    a = _mlstm_inputs(cuda, torch.float32, 2, 200, hd, seed=hd)
    b = _mlstm_inputs(cuda, torch.float32, 2, 200, hd, seed=hd + 1)
    first = ml.mlstm_parallel(*a)
    ml.mlstm_parallel(*b)
    again = ml.mlstm_parallel(*a)
    copied = ml.mlstm_parallel(*(t.clone() for t in a))
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, copied)


def _cancelling_inputs(dev, BH, S, hd, seed):
    """q.k of alternating sign (consecutive kv rows carry opposite keys of
    one random length along one direction, which every query shares), slow
    forget gates and input gates near 3: each row's sum of S[t, s] is a
    near-cancelling alternating sum, a median 1/27 of the sum of its |S|
    at (2, 1024, 512) and above exp(-m) in 97% of the rows, so the signed
    denominator amplifies the products' rounding.  float32, as the model
    hands K6 its operands."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(hd)
    u /= np.linalg.norm(u)
    q = rng.standard_normal((BH, S, hd)) * 0.1 / np.sqrt(hd) + u
    length = np.repeat(rng.standard_normal((BH, S // 2, 1)) * 0.5 + 1.0, 2,
                       axis=1)
    sign = np.where(np.arange(S) % 2 == 0, 1.0, -1.0)[None, :, None]
    k = length * sign * u + rng.standard_normal((BH, S, hd)) * 0.1 / np.sqrt(
        hd)
    v = rng.standard_normal((BH, S, hd)) / np.sqrt(hd)
    F = np.cumsum(-np.logaddexp(0.0, -(3.0 + rng.standard_normal((BH, S)))),
                  axis=1)
    i = 3.0 + 0.1 * rng.standard_normal((BH, S))
    return [_on(dev, a, torch.float32) for a in (q, k, v, F, i)]


def test_mlstm_near_cancelling_denominator_against_float64(cuda):
    """Where |sum_s S[t,s]| falls well below its terms, the kernel and the
    float32 plain version are each held against the plain version in
    float64; the kernel stays within 2e-4 of it.  Both distances are
    printed (pytest -s)."""
    args = _cancelling_inputs(cuda, 2, 1024, 512, seed=0)
    exact = ml.mlstm_parallel_plain(*args, dtype=torch.float64)
    got = ml.mlstm_parallel(*args)
    plain32 = ml.mlstm_parallel_plain(*args)
    torch.cuda.synchronize()
    d_kernel = float((got.double() - exact).abs().max())
    d_plain = float((plain32.double() - exact).abs().max())
    print(f"near-cancelling denominator, max abs distance to float64: "
          f"kernel {d_kernel}, float32 plain {d_plain}")
    torch.testing.assert_close(got.double(), exact, rtol=2e-4, atol=2e-4)


def _randn(dev, rng, shape, dtype, scale=1.0, shift=0.0):
    a = rng.standard_normal(shape) * scale + shift
    return _on(dev, a, torch.float32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [
    (8, 128), (256, 512), (1024, 4096), (64, 3584),   # reference shapes
    (100, 3000), (37, 1001), (4, 2048),               # ragged, decode
    (16, 16384), (4, 40000), (3, 9001),               # several warps a row
])
def test_rmsnorm_kernel_close_to_plain(cuda, rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    x = _randn(cuda, rng, (rows, d), dtype)
    s = _randn(cuda, rng, (d,), dtype, shift=1.0)
    before = LAUNCHES["rmsnorm"]
    got = rn.rmsnorm(x, s)
    want = rn.rmsnorm_plain(x, s)
    torch.cuda.synchronize()
    assert LAUNCHES["rmsnorm"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_rmsnorm_bf16_scale_is_one_launch(cuda):
    """A bf16 scale goes to the kernel as it is: one kernel on the card
    (the K7 kernel, no cast before it) and one counted launch.  The call
    is traced after a warm-up step of the same call: a tracer just
    started can lose the first device events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    rng = np.random.default_rng(14)
    x = _randn(cuda, rng, (64, 2048), torch.bfloat16)
    s = _randn(cuda, rng, (2048,), torch.bfloat16, shift=1.0)
    torch.cuda.synchronize()
    before = LAUNCHES["rmsnorm"]
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            got = rn.rmsnorm(x, s)
            torch.cuda.synchronize()
            prof.step()
    assert LAUNCHES["rmsnorm"] == before + 2
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0
               and not e.key.startswith("ProfilerStep")]
    assert [e.count for e in kernels] == [1], [e.key for e in kernels]
    assert "rmsnorm" in kernels[0].key
    torch.testing.assert_close(got.float(), rn.rmsnorm_plain(x, s).float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [
    (128, 512, 128), (256, 1024, 512), (128, 256, 384),   # reference shapes
    (100, 300, 200), (4, 2048, 8192), (1, 7, 3),          # ragged, decode
])
def test_swiglu_kernel_close_to_plain(cuda, M, K, N, dtype):
    rng = np.random.default_rng(M + K + N)
    x = _randn(cuda, rng, (M, K), dtype, 0.1)
    wg, wu = (_randn(cuda, rng, (K, N), dtype, 0.05) for _ in range(2))
    before = LAUNCHES["swiglu"]
    got = sg.swiglu(x, wg, wu)
    want = sg.swiglu_plain(x, wg, wu)
    torch.cuda.synchronize()
    assert LAUNCHES["swiglu"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("M,K,N", [
    (64, 16, 64), (64, 64, 64),                   # one wgmma tile
    (128, 300, 256), (128, 2047, 128),            # K not a multiple of 64
    (100, 256, 200), (129, 512, 136),             # ragged M and N tiles
    (4096, 2048, 8192),                           # llama3.2-1b's prefill
])
def test_swiglu_bf16_tensor_core_shapes(cuda, M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = _randn(cuda, rng, (M, K), torch.bfloat16, 0.1)
    wg, wu = (_randn(cuda, rng, (K, N), torch.bfloat16, K ** -0.5)
              for _ in range(2))
    before = LAUNCHES["swiglu"]
    got = sg.swiglu(x, wg, wu)
    want = sg.swiglu_plain(x, wg, wu)
    torch.cuda.synchronize()
    assert LAUNCHES["swiglu"] == before + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


def test_swiglu_bf16_misaligned_views_go_through_an_aligned_copy(
        cuda, monkeypatch):
    """TMA needs 16-byte-aligned rows: x one element off its allocation and
    weight slices at odd offsets are copied, aligned views read in place."""
    copied = []
    tma_operand = sg._tma_operand

    def spy(t):
        out = tma_operand(t)
        copied.append(out.data_ptr() != t.data_ptr())
        return out

    monkeypatch.setattr(sg, "_tma_operand", spy)
    rng = np.random.default_rng(17)
    x = _randn(cuda, rng, (96, 257), torch.bfloat16, 0.1)[:, 1:]
    w = _randn(cuda, rng, (256, 400), torch.bfloat16, 0.05)
    for wg, wu, want_copy in ((w[:, 3:139], w[:, 150:286], [True] * 3),
                              (w[:, 8:136], w[:, 264:392], [True, False,
                                                            False])):
        copied.clear()
        got = sg.swiglu(x, wg, wu)
        torch.cuda.synchronize()
        assert copied == want_copy
        torch.testing.assert_close(
            got.float(), sg.swiglu_plain(x, wg, wu).float(),
            **_tol(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_kernel_extreme_gate(cuda, dtype):
    """|gate| up to ~190: silu gives -0 for very negative g, not NaN.
    Small integers (u in 1/64ths) make every sum exact in fp32 in any
    order, so only silu and the product are compared."""
    rng = np.random.default_rng(21)
    x, wg, wu = (_on(cuda, a, dtype) for a in (
        rng.integers(-2, 3, (64, 256)), rng.integers(-3, 4, (256, 128)),
        rng.integers(-3, 4, (256, 128)) / 64))
    got = sg.swiglu(x, wg, wu)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), sg.swiglu_plain(x, wg, wu).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_swiglu_entry_points_read_views(cuda, dtype):
    """ops.rmsnorm / ops.swiglu take any leading shape; the wrappers read a
    row-strided x and column slices of the weights in place."""
    rng = np.random.default_rng(13)
    x = _randn(cuda, rng, (2, 3, 50, 520), dtype)[..., 4:516]
    s = _randn(cuda, rng, (512,), dtype, shift=1.0)
    got = ops.rmsnorm(x, s)
    want = rn.rmsnorm_plain(x.reshape(-1, 512), s).reshape(x.shape)
    assert got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    w = _randn(cuda, rng, (512, 300), dtype, 0.05)
    wg, wu = w[:, :136], w[:, 150:286]
    got = ops.swiglu(want, wg, wu)
    assert got.shape == (2, 3, 50, 136)
    torch.testing.assert_close(
        got.float(), sg.swiglu_plain(want.reshape(-1, 512), wg, wu)
        .reshape(got.shape).float(), **_tol(dtype))


def test_rmsnorm_swiglu_cuda_tensors_never_take_the_plain_path(
        cuda, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(rn, "rmsnorm_plain", refuse)
    monkeypatch.setattr(sg, "swiglu_plain", refuse)
    rng = np.random.default_rng(5)
    x = _randn(cuda, rng, (16, 256), torch.bfloat16)
    w = _randn(cuda, rng, (256, 64), torch.bfloat16)
    before = (LAUNCHES["rmsnorm"], LAUNCHES["swiglu"])
    ops.rmsnorm(x, torch.ones(256, device=cuda))
    ops.swiglu(x, w, w)
    torch.cuda.synchronize()
    assert (LAUNCHES["rmsnorm"], LAUNCHES["swiglu"]) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError, match="dtype"):
        sg.swiglu(x, w.float(), w)
    with pytest.raises(ValueError, match="contiguous"):
        sg.swiglu(x, w.t().contiguous().t(), w)
    with pytest.raises(TypeError, match="dtype"):
        rn.rmsnorm(x.half(), torch.ones(256, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        rn.rmsnorm(x, torch.ones(128, device=cuda))


# --------------------------------------------------------------------------
# The scheduler service on the card: every decision priced by K1/K2.
# --------------------------------------------------------------------------

SERVICE_POLICIES = ("sjf-bco", "sjf-bco-dynamic", "gadget-elastic",
                    "wang-ca")


def _service_case(hetero, n=24):
    from repro_torch.core.online import poisson_arrivals
    cluster = philly_cluster(5, seed=4, **(HETERO if hetero else {}))
    stream = poisson_arrivals(philly_workload(seed=4)[:n], rate=0.5, seed=4)
    return cluster, [a.job for a in stream], [a.arrival for a in stream]


def _service_drain(cluster, jobs, arrivals, policy, device, **kw):
    from repro_torch.service import SchedulerService, SubmitRequest
    svc = SchedulerService(cluster, policy=policy, device=device,
                           horizon=10**6, **kw)
    for job, a in zip(jobs, arrivals):
        svc.submit(SubmitRequest(job, int(a)))
    return svc, svc.drain()


def _service_same(a, b):
    (sa, ma), (sb, mb) = a, b
    assert len(sa.assignment) == len(sb.assignment)
    for (j1, g1), (j2, g2) in zip(sa.assignment, sb.assignment):
        assert j1 == j2 and np.array_equal(g1, g2)
    assert (sa.quotas is None) == (sb.quotas is None)
    if sa.quotas is not None:
        assert np.array_equal(sa.quotas, sb.quotas)
    assert np.array_equal(sa.est_start, sb.est_start)
    assert np.array_equal(sa.est_finish, sb.est_finish)
    assert np.array_equal(ma.finish, mb.finish)
    assert (ma.makespan, ma.avg_jct) == (mb.makespan, mb.avg_jct)


def _journal_rows(store):
    return [(e.kind, e.jid, e.to_json()) for e in store.entries()]


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("policy", SERVICE_POLICIES)
def test_card_daemon_equals_cpu_daemon(cuda, policy, hetero):
    from repro_torch.kernels import reset_launch_counts
    cluster, jobs, arrivals = _service_case(hetero)
    host, want = _service_drain(cluster, jobs, arrivals, policy, "cpu")
    reset_launch_counts()
    card, got = _service_drain(cluster, jobs, arrivals, policy, cuda)
    torch.cuda.synchronize()
    kernel = "tau_het" if hetero else "tau"
    assert LAUNCHES[kernel] > 0
    assert LAUNCHES["tau" if hetero else "tau_het"] == 0
    assert card.daemon.state.engine == "batched"
    _service_same(want, got)
    assert _journal_rows(card.daemon.store) == _journal_rows(host.daemon.store)


@pytest.mark.parametrize("hetero", [False, True])
def test_card_run_online_equals_cpu(cuda, hetero):
    from repro_torch.core.online import poisson_arrivals, run_online
    cluster = philly_cluster(5, seed=4, **(HETERO if hetero else {}))
    stream = poisson_arrivals(philly_workload(seed=4)[:24], rate=0.5, seed=4)
    before = LAUNCHES["tau_het" if hetero else "tau"]
    for policy in SERVICE_POLICIES:
        a_cpu, s_cpu = run_online(cluster, stream, policy=policy,
                                  device="cpu")
        a_card, s_card = run_online(cluster, stream, policy=policy,
                                    device=cuda)
        assert len(a_cpu) == len(a_card)
        for (j1, g1), (j2, g2) in zip(a_cpu, a_card):
            assert j1 == j2 and np.array_equal(g1, g2)
        assert np.array_equal(s_cpu.finish, s_card.finish)
    assert LAUNCHES["tau_het" if hetero else "tau"] > before


def _resize_trace():
    """``tests/test_torch_preempt.py``'s tight-theta trace: gadget-elastic
    shrinks job 0 to make room for job 1."""
    from repro_torch.core import Job
    cluster = Cluster(capacities=(4,))
    jobs = [Job(jid=0, num_gpus=4, iters=2000, grad_size=0.25, batch=32,
                dt_fwd=3e-4, dt_bwd=8e-3),
            Job(jid=1, num_gpus=2, iters=100, grad_size=0.05, batch=32,
                dt_fwd=3e-4, dt_bwd=8e-3)]
    return cluster, jobs, np.array([0, 5], dtype=np.int64), 35


def test_card_gadget_elastic_resize_equals_cpu(cuda):
    """The elastic resize path on the card (batched engine, K1 pricing):
    schedule, quotas, simulation and journal bitwise the CPU's."""
    from repro_torch.service import Daemon, QueueManager, TenantConfig
    cluster, jobs, arrivals, horizon = _resize_trace()
    runs = []
    for device in ("cpu", cuda):
        daemon = Daemon(cluster, None, QueueManager(
            default=TenantConfig(policy="gadget-elastic")), horizon=horizon,
            device=device)
        for job, a in zip(jobs, arrivals):
            daemon.admit(job, arrival=int(a))
        before = LAUNCHES["tau"]
        runs.append((daemon, daemon.drain(), LAUNCHES["tau"] - before))
    (host, want, _), (card, got, launched) = runs
    torch.cuda.synchronize()
    assert card.state.engine == "batched" and launched > 0
    assert "resize" in [e.kind for e in card.store.entries()]
    assert {j: len(g) for j, g in got[0].assignment}[0] < jobs[0].num_gpus
    _service_same(want, got)
    assert _journal_rows(card.store) == _journal_rows(host.store)


@pytest.mark.parametrize("policy", ["sjf-bco", "sjf-bco-dynamic"])
def test_card_recovers_a_truncated_sqlite_journal(cuda, tmp_path, policy):
    from repro_torch.service import (SchedulerService, SqliteStore,
                                     SubmitRequest)
    cluster, jobs, arrivals = _service_case(False, n=30)
    path = str(tmp_path / "full.db")
    full, want = _service_drain(cluster, jobs, arrivals, policy, cuda,
                                store_path=path)
    entries = full.daemon.store.entries()
    full.close()
    cut, cut_cpu = str(tmp_path / "cut.db"), str(tmp_path / "cut_cpu.db")
    for name in (cut, cut_cpu):
        store = SqliteStore(name)
        for e in entries[:len(entries) // 2]:
            store.append(e.kind, e.jid, e.payload, ts=e.ts)
        store.close()
    on_cpu = SchedulerService.recover(None, cut_cpu, policy=policy,
                                      device="cpu", horizon=10**6)
    rec = SchedulerService.recover(None, cut, policy=policy, device=cuda,
                                   horizon=10**6)
    assert np.array_equal(rec.daemon.state.U, on_cpu.daemon.state.U)
    assert np.array_equal(rec.daemon.state.R, on_cpu.daemon.state.R)
    for job, a in list(zip(jobs, arrivals))[len(rec.daemon.jobs):]:
        rec.submit(SubmitRequest(job, int(a)))
    got = rec.drain()
    _service_same(want, got)
    rec.close()
    on_cpu.close()


def test_card_daemon_leaves_the_tau_switch_unset(cuda):
    """The tau backend is module-wide: the card daemon sets it for each
    chooser run and a CPU caller between two steps sees it unset."""
    from repro_torch.core import contention
    from repro_torch.service import SchedulerService, SubmitRequest
    cluster, jobs, arrivals = _service_case(False, n=12)
    svc = SchedulerService(cluster, device=cuda, horizon=10**6)
    seen = []
    chooser = svc.daemon._chooser_for("default")

    def spy(*args):
        seen.append((contention.TAU_BACKEND, contention.TAU_DEVICE))
        return chooser(*args)

    svc.daemon._choosers["default"] = spy
    for job, a in zip(jobs, arrivals):
        svc.submit(SubmitRequest(job, int(a)))
    steps = 0
    while svc.step():
        steps += 1
        assert contention.TAU_BACKEND == "numpy"
        assert contention.TAU_DEVICE is None
    assert steps > 1 and len(seen) == len(jobs)
    assert all(b == "kernel" and d.type == "cuda" for b, d in seen)


# --------------------------------------------------------------------------
# The CUDA kernels refuse autograd: none has a backward.
# --------------------------------------------------------------------------


def _tracked(t):
    return t.detach().requires_grad_(True)


def test_flash_kernel_refuses_autograd(cuda):
    q, k, v = _qkv(cuda, torch.float32, 1, 2, 1, 16, 16, 32, 0)
    before = LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(_tracked(q), k, v)
    with torch.no_grad():
        fa.flash_attention(_tracked(q), k, v)
    assert LAUNCHES["flash_attention"] == before + 1


def test_mlstm_kernel_refuses_autograd(cuda):
    q, k, v, F, i_pre = _mlstm_inputs(cuda, torch.float32, 2, 16, 64, 0)
    before = LAUNCHES["mlstm"]
    with pytest.raises(RuntimeError, match="no backward"):
        ml.mlstm_parallel(q, k, _tracked(v), F, i_pre)
    with torch.no_grad():
        ml.mlstm_parallel(q, k, _tracked(v), F, i_pre)
    assert LAUNCHES["mlstm"] == before + 1


def test_rmsnorm_kernel_refuses_autograd(cuda):
    x = torch.randn(8, 128, device=cuda)
    scale = torch.ones(128, device=cuda)
    before = LAUNCHES["rmsnorm"]
    with pytest.raises(RuntimeError, match="no backward"):
        rn.rmsnorm(x, _tracked(scale))
    with torch.no_grad():
        rn.rmsnorm(_tracked(x), scale)
    assert LAUNCHES["rmsnorm"] == before + 1


def test_swiglu_kernel_refuses_autograd(cuda):
    x = torch.randn(64, 128, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(128, 64, device=cuda, dtype=torch.bfloat16)
    before = LAUNCHES["swiglu"]
    with pytest.raises(RuntimeError, match="no backward"):
        sg.swiglu(_tracked(x), w, w)
    with torch.no_grad():
        sg.swiglu(x, _tracked(w), w)
    assert LAUNCHES["swiglu"] == before + 1


# --------------------------------------------------------------------------
# Training on the card: the ring, the RAR step and checkpoints against the
# same code on the CPU.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,n", [(2, 7), (3, 100), (4, 4096), (8, 1001)])
def test_card_ring_equals_cpu_ring(cuda, w, n, dtype):
    from repro_torch.dist import rar
    x = torch.tensor(np.random.default_rng(w * n).standard_normal((w, n)),
                     dtype=dtype)
    want = rar.ring_all_reduce(x)
    rar.reset_ring_counts()
    got = rar.ring_all_reduce(x.to(cuda))
    assert rar.ring_counts()["steps"] == 2 * (w - 1)
    assert torch.equal(got.cpu(), want)
    buf = x.to(cuda)
    assert rar.ring_all_reduce(buf, out=buf) is buf
    assert torch.equal(buf.cpu(), want)


def _reduced_llama(device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return build_model(get_config("llama3.2-1b").reduced(), 64,
                       device=device)


def _to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def test_card_rar_step_equals_cpu(cuda):
    """Three steps on the CPU, then one RAR step (w = 4) from that state
    on both devices: loss 1e-3 and params 2e-4 (the CPU tests' bounds
    against the reference), every ring row the same bits."""
    from repro_torch.dist import steps
    from repro_torch.dist.steps import RingMesh, make_rar_train_step
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    cpu_model, card_model = _reduced_llama("cpu"), _reduced_llama(cuda)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    params = cpu_model.init(0)
    opt = adamw.init(ocfg, params)
    rng = np.random.default_rng(8)
    batch = lambda: {"tokens": torch.tensor(  # noqa: E731
        rng.integers(0, 512, (8, 32)), dtype=torch.int32)}
    cpu_step = make_rar_train_step(cpu_model, ocfg, RingMesh(range(4), "cpu"))
    for _ in range(3):
        params, opt, _ = cpu_step(params, opt, batch())
    b = batch()
    want = cpu_step(params, opt, b)
    got = make_rar_train_step(card_model, ocfg, RingMesh(range(4), cuda))(
        _to(params, cuda), _to(opt, cuda), _to(b, cuda))
    assert got[2]["replicated"] is True
    assert abs(float(got[2]["loss"]) - float(want[2]["loss"])) <= 1e-3
    assert max(float((a.cpu() - c).abs().max())
               for a, c in zip(leaves(got[0]), leaves(want[0]))) <= 2e-4
    assert all(t.device.type == cuda.type
               for t in leaves(got[0]) + leaves(got[1]))
    assert steps.RING_AXIS == "data"


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_card_checkpoint_round_trip(cuda, tmp_path, moments):
    from repro_torch import ckpt
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    model = _reduced_llama(cuda)
    params = model.init(0)
    ocfg = adamw.AdamWConfig(moment_dtype=moments)
    opt = adamw.init(ocfg, params)
    opt["m"] = _to(opt["m"], cuda)
    for t in leaves(opt["m"]):
        t.normal_()
    path = str(tmp_path / "card.npz")
    ckpt.save(path, params=params, opt_state=opt, step=4)
    like = _to(params, cuda)
    got, gopt, step = ckpt.load(path, params_like=like,
                                opt_like=adamw.init(ocfg, like))
    assert step == 4
    for a, b in zip(leaves(got) + leaves(gopt), leaves(params) + leaves(opt)):
        assert a.device.type == cuda.type and a.dtype == b.dtype
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the moe, hybrid and audio families on the card (phase 11's gates at
# reduced width)
# ---------------------------------------------------------------------------

FAMILIES = {
    # arch: knobs on top of reduced(): hymba deep enough for a windowed
    # layer, whisper's frames long enough for K5 (S >= 128)
    "deepseek-moe-16b": dict(),
    "hymba-1.5b": dict(n_layers=4),
    "whisper-tiny": dict(enc_frames=150),
}


def _family(arch, device, **knobs):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch).reduced(), **FAMILIES[arch],
                              **knobs)
    return build_model(cfg, 448, device=device)


def _family_batch(cfg, device, B=2, S=256, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": _on(device, rng.integers(0, cfg.vocab, (B, S)),
                           torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = _on(device, rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)), torch.float32)
    return batch


def _k5_calls(monkeypatch):
    from repro_torch.models import layers
    calls, real = [], layers.kops.flash_attention

    def counted(*args, **kw):
        calls.append(kw.get("causal", True))
        return real(*args, **kw)

    monkeypatch.setattr(layers.kops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_prefill_kernel_on_vs_off(cuda, monkeypatch, arch):
    """float32: K5 on within 2e-4 of K5 off; K5 launched once per
    self-attention layer (whisper: the encoder's non-causal, then the
    decoder's causal, none for cross-attention)."""
    on = _family(arch, cuda, use_flash_kernel=True)
    off = _family(arch, cuda)
    cfg = on.config
    params = on.init(0)
    batch = _family_batch(cfg, cuda)
    calls = _k5_calls(monkeypatch)
    before = LAUNCHES["flash_attention"]
    got = on.prefill(params, batch)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + len(calls)
    assert calls == [False] * cfg.n_enc_layers + [True] * cfg.n_layers
    want = off.prefill(params, batch)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_decode_vs_prefill(cuda, arch):
    """float32: 16 stepped positions (whisper: the encoder output pinned
    into the cache; hymba: Mamba's recurrence) within 2e-2 of the K5
    prefill (the MoE's reduced capacity drops nothing)."""
    model = _family(arch, cuda, use_flash_kernel=True)
    params = model.init(0)
    batch = _family_batch(model.config, cuda)
    full = model.prefill(params, batch)
    cache = model.init_cache(2, 16)
    if model.encode is not None:
        cache["enc_out"] = model.encode(params, batch["frames"])
    steps = []
    for pos in range(16):
        lg, cache = model.decode_step(
            params, cache, batch["tokens"][:, pos],
            torch.full((2,), pos, dtype=torch.int32, device=cuda))
        steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, 1), full[:, :16],
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-tiny"])
def test_family_bf16_prefill_near_float32(cuda, arch):
    """bf16 compute: K5 on no farther from a float32 K5-off prefill of the
    same params and inputs than 1.5x K5 off's distance."""
    on = _family(arch, cuda, use_flash_kernel=True,
                 compute_dtype="bfloat16")
    off = _family(arch, cuda, compute_dtype="bfloat16")
    params = on.init(0)
    batch = _family_batch(on.config, cuda)
    ref = _family(arch, cuda).prefill(params, batch)
    d_on, d_off = (float((m.prefill(params, batch).float() - ref).abs().max())
                   for m in (on, off))
    assert d_on <= 1.5 * d_off


@pytest.mark.parametrize("B,H,K,S,hd,causal,window", [
    (4, 16, 16, 1024, 128, True, 0),     # deepseek-moe-16b
    (4, 25, 5, 1024, 64, True, 1024),    # hymba-1.5b
    (2, 6, 6, 1500, 64, False, 0),       # whisper-tiny's encoder
    (1, 25, 5, 2048, 64, True, 1024),    # hymba's window biting
])
def test_flash_kernel_at_family_shapes(cuda, B, H, K, S, hd, causal, window):
    """K5 in bf16 at the three families' serving shapes, in the model
    layout the prefill hands it, within 2e-2 of its plain version."""
    rng = np.random.default_rng(S + H)
    q, k, v = (_on(cuda, rng.standard_normal((B, S, n, hd)), torch.bfloat16)
               .transpose(1, 2) for n in (H, K, K))
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_moe_combine_is_deterministic_on_the_card(cuda):
    """The combine sums each token's k pairs in a fixed order (no atomic
    adds): two bf16 runs give the same bits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import generator
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              compute_dtype="bfloat16", n_experts=16,
                              n_shared_experts=1, d_model=512, d_expert=256)
    p = moe.init_moe(generator(cuda, 0), cfg, torch.float32)
    x = _on(cuda, np.random.default_rng(3).standard_normal((4, 512, 512)),
            torch.bfloat16)
    a, aux_a = moe.moe_apply(cfg, p, x)
    b, aux_b = moe.moe_apply(cfg, p, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_sched_launch_six_jobs_card_equals_cpu(cuda):
    """The launcher with every family of its pool (6 jobs, 4 GPUs on 2
    servers, 2 steps): the card's schedule and simulated run equal the
    CPU's, every job's losses finite."""
    from repro_torch.launch import sched_launch
    argv = ["--devices", "4", "--servers", "2", "--jobs", "6", "--steps",
            "2"]
    card = sched_launch.main(argv + ["--device", "cuda"])
    host = sched_launch.main(argv + ["--device", "cpu"])
    placed = [[(int(j), [int(g) for g in ids])
               for j, ids in out["schedule"].assignment]
              for out in (card, host)]
    assert placed[0] == placed[1]
    for f in ("start", "finish", "makespan", "avg_jct"):
        assert np.array_equal(getattr(card["sim"], f),
                              getattr(host["sim"], f))
    assert all(np.isfinite(v).all() for v in card["losses"].values())


# ---------------------------------------------------------------------------
# the production-mesh dry-run on the card (launch/dryrun.py)
# ---------------------------------------------------------------------------


def test_dryrun_pair_on_fake_cuda_tensors(cuda):
    """One full-width pair on the single-pod mesh, fake CUDA tensors over
    a fake group of 256 ranks: it runs, counts, and sends collectives."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    try:
        row = dryrun.run_pair("llama3.2-1b", "decode_32k", device="cuda",
                              verbose=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert row["chips"] == 256 and row["mesh"] == "16x16"
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
    assert row["collective_bytes"] > 0
    assert 0 < row["hbm_peak_bytes"] < 80 * 2**30


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_one_rank_fake_equals_real(cuda, kind):
    """On one real rank (nccl, world size 1, a 1x1 mesh) the reduced
    llama3.2-1b step counts the same FLOPs and collectives on fake and on
    real CUDA tensors."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import InputShape
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        cfg = get_config("llama3.2-1b").reduced()
        shape = InputShape("mini", 256, 4, kind)
        fake = dryrun.dry_run("llama3.2-1b", shape, mesh, cfg=cfg)
        real = dryrun.dry_run("llama3.2-1b", shape, mesh, cfg=cfg,
                              fake=False)
    finally:
        dist.destroy_process_group()
    assert fake["hlo_flops"] == real["hlo_flops"] > 0
    assert fake["collective_counts"] == real["collective_counts"]
    assert real["wall_s"] > 0


@pytest.mark.parametrize("train", [False, True], ids=["fwd", "fwd+bwd"])
def test_slstm_scan_counts_on_fake_cuda_tensors(cuda, train):
    """The sLSTM scan as one op (models/slstm_scan.py) counts what the
    loop counts on fake CUDA tensors (log_sigmoid keeps no buffer there):
    xlstm-350m widths, B 2, S 64, gx in bf16."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.models import ssm
    from repro_torch.models.slstm_scan import slstm_scan
    cfg = get_config("xlstm-350m")
    H, d = cfg.n_heads, cfg.d_model
    rows = []
    for fn in (lambda r, g: ssm._slstm_loop(cfg, r, g), slstm_scan):
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        with mode:
            r_h = torch.randn(H, d // H, 4 * d // H, device=cuda,
                              requires_grad=train)
            gx = torch.randn(2, 64, 4 * d, dtype=torch.bfloat16,
                             device=cuda, requires_grad=train)
            grad_h = torch.randn(2, 64, H, d // H, device=cuda)
        counter = roofline.CostCounter(fake_mode=mode)
        peak = roofline.PeakMemory([r_h, gx, grad_h], mode)
        with counter, peak, torch.set_grad_enabled(train):
            h = fn(r_h, gx)
            if train:
                torch.autograd.grad(h, (r_h, gx), grad_h)
        rows.append((counter.flops, counter.bytes, peak.peak))
    (loop_f, loop_b, loop_p), (op_f, op_b, op_p) = rows
    assert op_f == loop_f > 0 and op_b == loop_b > 0
    assert abs(op_p - loop_p) <= 0.05 * loop_p
