"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: every test asks the ``cuda`` fixture for the card and
skips where there is none.  The file imports neither JAX nor the
reference, so it runs on a machine with the card but no JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Inputs are the §7 shapes' small cousins, made from numpy seeds; every
comparison is ``torch.equal`` (float64, bit for bit).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import philly_cluster, philly_workload
from repro_torch.core.contention import _job_terms
from repro_torch.kernels import LAUNCHES, placement, tau

HETERO = dict(speed_tiers=((50.0, 0.5), (12.5, 0.5)),
              link_classes=((1.25, "shared", 0.5), (1.25, "isolated", 0.5)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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


@pytest.mark.parametrize("G", [1, 4, 16, 64])
def test_pool_kernel_equals_plain(cuda, G):
    cluster = _cluster(5, hetero=False)
    rng = np.random.default_rng(3)
    U = np.round(rng.uniform(0, 30, size=(64, cluster.num_gpus)), 3)
    U[:, :40] = 0.0                           # idle GPUs: exact-tie loads
    th_lo = np.sort(rng.uniform(5, 40, size=64))
    args = (_on(cuda, U, torch.float64), _on(cuda, th_lo, torch.float64),
            _on(cuda, th_lo + 3.0, torch.float64),
            _on(cuda, rng.uniform(0.5, 20, size=64), torch.float64))
    ct = tau.cluster_tensors(cluster, cuda)
    before = LAUNCHES["pool"]
    got = placement.pool_stats(*args, G, ct["offsets"], ct["caps"])
    want = placement.pool_stats_plain(*args, G, ct["offsets"], ct["caps"])
    torch.cuda.synchronize()
    assert LAUNCHES["pool"] == before + 1
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("hetero", [False, True])
def test_score_kernel_equals_plain(cuda, hetero):
    cluster = _cluster(7, hetero)
    S = cluster.num_servers
    rng = np.random.default_rng(4)
    Y = rng.integers(0, 3, size=(64, S))
    f = 1.0 + rng.uniform(0, 3, size=64)
    gamma = cluster.xi2 * (Y > 0).sum(axis=1)
    scalars = np.array([0.002, 0.001, 0.001 / 50.0, 0.02, 3000.0])
    ct = tau.cluster_tensors(cluster, cuda)
    args = (_on(cuda, Y, torch.int64), _on(cuda, f, torch.float64),
            _on(cuda, gamma, torch.float64),
            _on(cuda, scalars, torch.float64), ct["speed_floor"],
            ct["uplink_sh"], ct["uplink_iso"])
    kw = dict(hetero=hetero, b_inter=cluster.b_inter,
              b_intra=cluster.b_intra)
    before = LAUNCHES["score"]
    got = placement.score_rows(*args, **kw)
    want = placement.score_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["score"] == before + 1
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_cuda_tensor_never_takes_the_plain_path(cuda):
    """A CUDA tensor launches the kernel (counted) or raises."""
    bad = torch.zeros((2, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        placement.pool_stats(bad, *(torch.zeros(2, dtype=torch.float64,
                                                device=cuda),) * 3, 1,
                             torch.zeros(1, dtype=torch.int64, device=cuda),
                             torch.ones(1, dtype=torch.int64, device=cuda))
