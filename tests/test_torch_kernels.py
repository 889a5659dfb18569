"""The port's kernel modules against the JAX reference, bit for bit.

Each module of :mod:`repro_torch.kernels` is fed the same NumPy inputs as
its counterpart in :mod:`repro.kernels` (carried across through
:func:`repro_torch.convert.from_reference`) and must agree with
``np.array_equal`` in float64 -- the reference's own engine contract, no
tolerance:

  * ``tau_stack`` (CPU: the plain PyTorch versions of the tau kernels)
    against the reference's Pallas kernel in x64 interpret mode and its
    NumPy ``evaluate_many``, homogeneous and heterogeneous, [J] and
    [C, J] terms; the packed layout of its card path, and that path's
    call site driven on the CPU with a stand-in for the C call;
  * ``pick_orders`` / ``score_probes`` against the reference's Pallas
    path (``use_kernel=True``, dispatch threshold forced to 0) and its
    NumPy fallback, fuzzed over random clock states and on the ranking's
    edge cases (no feasible GPU, no server fitting G, tied and signed-zero
    clocks, an LBSGF prefix of every server, G = N), with the degradation
    terms derived from p.

``tests/test_torch_gpu.py`` holds each CUDA kernel against its plain
version on the card.
"""
import ctypes
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.kernels.placement as ref_kp
from repro.core import philly_cluster as ref_philly_cluster
from repro.core import philly_workload as ref_philly_workload
from repro.core.cluster import Cluster as RefCluster
from repro.core.contention import _job_terms as ref_job_terms
from repro.core.contention import evaluate_many as ref_evaluate_many
from repro.kernels.tau import tau_stack as ref_tau_stack
from repro_torch.convert import from_reference
from repro_torch.core.contention import evaluate_many, tau_backend
from repro_torch.kernels import launch_counts, placement, tau

HETERO = dict(speed_tiers=((50.0, 0.5), (12.5, 0.5)),
              link_classes=((1.25, "shared", 0.5), (1.25, "isolated", 0.5)))


@pytest.fixture
def x64():
    """The reference's kernel paths compute in float64 only under x64."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _carry(ref_cluster, ref_jobs):
    return from_reference(ref_cluster.to_payload(),
                          [dataclasses.asdict(j) for j in ref_jobs])


def _tau_case(seed, hetero, n_cands=6):
    """A 6-server Philly cluster, 14 jobs and a random candidate stack."""
    rng = np.random.default_rng(seed)
    cluster = ref_philly_cluster(6, seed=seed, **(HETERO if hetero else {}))
    jobs = ref_philly_workload(seed=seed, mix=((1, 4), (2, 4), (4, 4),
                                               (8, 2)))
    S = cluster.num_servers
    stack = np.zeros((n_cands, len(jobs), S), dtype=np.int64)
    for c in range(n_cands):
        for i, job in enumerate(jobs):
            for _ in range(job.num_gpus):
                stack[c, i, rng.integers(S)] += 1
    return cluster, jobs, stack


def _per_candidate_terms(rng, stack, G, share, compute):
    """The columnar [C, J] layout: each candidate holds its own row order
    plus zero padding rows (G = 0, share = 0, compute = 1)."""
    C, J, S = stack.shape
    pad = 3
    Y = np.zeros((C, J + pad, S), dtype=np.int64)
    G2 = np.zeros((C, J + pad), dtype=np.int64)
    sh2 = np.zeros((C, J + pad))
    cp2 = np.ones((C, J + pad))
    for c in range(C):
        perm = rng.permutation(J)
        Y[c, :J] = stack[c, perm]
        G2[c, :J], sh2[c, :J], cp2[c, :J] = G[perm], share[perm], \
            compute[perm]
    return Y, G2, sh2, cp2


class TestTauStack:
    """K1/K2: the plain versions against the reference kernel and NumPy."""

    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("terms_2d", [False, True])
    def test_matches_reference_kernel(self, seed, hetero, terms_2d, x64):
        ref_cluster, ref_jobs, stack = _tau_case(seed, hetero)
        cluster, _ = _carry(ref_cluster, ref_jobs)
        G, share, compute = ref_job_terms(ref_jobs)
        if terms_2d:
            stack, G, share, compute = _per_candidate_terms(
                np.random.default_rng(seed + 100), stack, G, share, compute)
        want = ref_tau_stack(ref_cluster, G, share, compute, stack)
        before = launch_counts()
        got = tau.tau_stack(cluster, G, share, compute, stack, device="cpu")
        assert launch_counts() == before     # CPU tensors launch nothing
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            assert np.array_equal(w, g)

    @pytest.mark.parametrize("seed", [1, 3])
    @pytest.mark.parametrize("hetero", [False, True])
    def test_kernel_backend_matches_numpy_engines(self, seed, hetero):
        """The port's stack_model under tau_backend("kernel") equals the
        reference's NumPy evaluate_many on every IterModel field."""
        ref_cluster, ref_jobs, stack = _tau_case(seed, hetero)
        cluster, jobs = _carry(ref_cluster, ref_jobs)
        want = ref_evaluate_many(ref_cluster, ref_jobs, stack)
        with tau_backend("kernel", device="cpu"):
            got = evaluate_many(cluster, jobs, stack)
        for field in dataclasses.fields(want):
            assert np.array_equal(getattr(want, field.name),
                                  getattr(got, field.name)), field.name

    def test_wrapper_rejects_bad_tensors(self):
        Y = torch.zeros((2, 3, 4), dtype=torch.int64)
        G = torch.ones(3, dtype=torch.int64)
        f64 = torch.zeros(3, dtype=torch.float64)
        kw = dict(xi1=0.7, xi2=0.002, alpha=0.3, b_inter=1.25,
                  b_intra=300.0, gpu_speed=50.0)
        with pytest.raises(TypeError, match="dtype"):
            tau.tau_stack_hom(Y.to(torch.int32), G, f64, f64, **kw)
        with pytest.raises(ValueError, match="shape"):
            tau.tau_stack_hom(Y, G, torch.zeros(4, dtype=torch.float64),
                              f64, **kw)
        with pytest.raises(ValueError, match="contiguous"):
            tau.tau_stack_hom(Y.transpose(0, 2).contiguous().transpose(0, 2),
                              G, f64, f64, **kw)


def _tau_arrays(rng, C, J, S, terms_2d):
    """(G, share, compute, Y) at random, with [J] or [C, J] terms."""
    shape = (C, J) if terms_2d else (J,)
    Y = rng.integers(1, 5, (C, J, S)) * (rng.random((C, J, S)) < 0.2)
    return (rng.integers(1, 6, shape), rng.uniform(0.1, 10.0, shape),
            rng.uniform(1, 5, shape), Y)


def _words_at(ptr, n):
    """The n int64 words at address ``ptr`` as a NumPy array (no copy)."""
    return np.ctypeslib.as_array((ctypes.c_int64 * n).from_address(ptr))


def _stand_in(name):
    """A Python stand-in for ``tau_step_hom`` / ``tau_step_het`` of
    ``csrc/tau.cu`` over CPU buffers: the copy up, the plain version over
    the words at the offsets it is handed, the outputs written one after
    the other and copied back, as the C call does them; the device's
    output words are overwritten after the copy, so a host pointer taken
    for a device one shows."""
    hetero = name == "tau_step_het"

    def step(host_in, dev_in, n_in, g, sh, cp, *rest):
        if hetero:
            *servers, dev_out, host_out, C, J, S, stride, xi1, xi2, alpha, \
                b_intra, _ = rest
        else:
            dev_out, host_out, C, J, S, stride, xi1, xi2, alpha, b_inter, \
                b_intra, gpu_speed, _ = rest
        _words_at(dev_in, n_in)[:] = _words_at(host_in, n_in)
        w = torch.from_numpy(_words_at(dev_in, n_in))
        f = w.view(torch.float64)
        shape, T = ((C, J), C * J) if stride else ((J,), J)
        args = (w[:C * J * S].view(C, J, S), w[g:g + T].view(shape),
                f[sh:sh + T].view(shape), f[cp:cp + T].view(shape))
        if hetero:
            terms = [torch.from_numpy(_words_at(ptr, S).view(np.float64))
                     for ptr in servers]
            outs = tau.tau_stack_het_plain(*args, *terms, xi1=xi1, xi2=xi2,
                                           alpha=alpha, b_intra=b_intra)
        else:
            outs = tau.tau_stack_hom_plain(*args, xi1=xi1, xi2=xi2,
                                           alpha=alpha, b_inter=b_inter,
                                           b_intra=b_intra,
                                           gpu_speed=gpu_speed)
        out = _words_at(dev_out, 3 * C * J)
        for i, o in enumerate(outs):
            out[i * C * J:(i + 1) * C * J] = o.reshape(-1).numpy().view(
                np.int64)
        _words_at(host_out, 3 * C * J)[:] = out
        out[:] = -1          # device words, which the host never reads
        return 0

    return step


class TestTauRoundTrip:
    """The card path of ``tau_stack``: its packed layout, and its call
    site over CPU buffers with a stand-in for the C call."""

    @pytest.mark.parametrize("terms_2d", [False, True])
    @pytest.mark.parametrize("C,J,S", [(1, 1, 1), (3, 5, 7), (64, 161, 20),
                                       (2, 1025, 32), (5, 3, 1), (0, 4, 3)])
    def test_offsets_are_16_byte_aligned_and_disjoint(self, C, J, S,
                                                      terms_2d):
        g, sh, cp, n = tau.tau_words(C, J, S, terms_2d)
        T = C * J if terms_2d else J
        for off in (g, sh, cp):
            assert (8 * off) % 16 == 0
        assert C * J * S <= g and g + T <= sh and sh + T <= cp
        assert n == cp + T and n - C * J * S - 3 * T <= 3

    @pytest.mark.parametrize("terms_2d", [False, True])
    @pytest.mark.parametrize("C,J,S", [(3, 5, 7), (64, 161, 20), (1, 1, 1)])
    def test_pack_then_unpack_gives_each_input_back(self, C, J, S,
                                                    terms_2d):
        rng = np.random.default_rng(C * J + S)
        G, share, compute, Y = _tau_arrays(rng, C, J, S, terms_2d)
        special = np.array([-0.0, np.inf, 5e-324])
        share.reshape(-1)[:3] = special[:share.size]
        g, sh, cp, n = tau.tau_words(C, J, S, terms_2d)
        words = rng.integers(-2**62, 2**62, n + 9)       # a stale buffer
        assert tau.pack_stack(words, Y, G, share, compute) == n
        T, f = G.size, words.view(np.float64)
        assert np.array_equal(words[:Y.size].reshape(Y.shape), Y)
        assert np.array_equal(words[g:g + T].reshape(G.shape), G)
        for off, a in ((sh, share), (cp, compute)):
            assert np.array_equal(f[off:off + T].reshape(a.shape).view(
                np.int64), a.view(np.int64))

    @pytest.mark.parametrize("hetero", [False, True])
    def test_cpu_tau_stack_runs_the_plain_versions(self, hetero):
        """On the CPU, tau_stack builds no staging, launches nothing and
        gives the plain versions' bits."""
        ref_cluster, ref_jobs, stack = _tau_case(4, hetero)
        cluster, _ = _carry(ref_cluster, ref_jobs)
        G, share, compute = ref_job_terms(ref_jobs)
        staged, before = tau._staging.cache_info().currsize, launch_counts()
        got = tau.tau_stack(cluster, G, share, compute, stack, device="cpu")
        assert launch_counts() == before
        assert tau._staging.cache_info().currsize == staged
        args = (torch.from_numpy(stack), torch.from_numpy(G),
                torch.from_numpy(share), torch.from_numpy(compute))
        kw = dict(xi1=cluster.xi1, xi2=cluster.xi2, alpha=cluster.alpha,
                  b_intra=cluster.b_intra)
        if hetero:
            ct = tau.cluster_tensors(cluster, torch.device("cpu"))
            want = tau.tau_stack_het_plain(*args, ct["speed_floor"],
                                           ct["uplink_sh"], ct["uplink_iso"],
                                           **kw)
        else:
            want = tau.tau_stack_hom_plain(*args, b_inter=cluster.b_inter,
                                           gpu_speed=cluster.gpu_speed, **kw)
        for w, g in zip(want, got):
            assert g.dtype == w.numpy().dtype
            assert np.array_equal(w.numpy(), g)

    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("terms_2d", [False, True])
    def test_call_site_on_a_stand_in(self, hetero, terms_2d, monkeypatch):
        """The card path's packing, pointers, offsets and copy-out, driven
        over CPU buffers: growing then shrinking stacks (later calls read
        a stale tail) equal the CPU path, one launch counted each, and a
        result is not overwritten by the calls after it."""
        staging = tau._Staging(torch.device("cpu"))
        monkeypatch.setattr(tau, "_step_fn", _stand_in)
        monkeypatch.setattr(tau, "_current", lambda: (0, 0))
        monkeypatch.setattr(tau, "_staging", lambda index: staging)
        ref_cluster = ref_philly_cluster(8, seed=2,
                                         **(HETERO if hetero else {}))
        cluster, _ = _carry(ref_cluster, [])
        rng = np.random.default_rng(7 + hetero + 2 * terms_2d)
        name = "tau_het" if hetero else "tau"
        kept = []
        for C, J in [(2, 5), (64, 161), (3, 4), (1, 1), (16, 1025), (2, 9)]:
            G, share, compute, Y = _tau_arrays(rng, C, J, cluster.num_servers,
                                               terms_2d)
            before = launch_counts()[name]
            got = tau._round_trip(cluster, G, share, compute, Y, False)
            assert launch_counts()[name] == before + 1
            want = tau.tau_stack(cluster, G, share, compute, Y, device="cpu")
            for w, g in zip(want, got):
                assert g.dtype == w.dtype and g.shape == (C, J)
                assert np.array_equal(w, g)
            kept.append((got, [a.copy() for a in got]))
        for got, copies in kept:
            for g, c in zip(got, copies):
                assert np.array_equal(g, c)

    def test_rejects_bad_arrays(self):
        cluster, _ = _carry(ref_philly_cluster(4, seed=1), [])
        G, share, compute, Y = _tau_arrays(np.random.default_rng(0), 2, 3,
                                           cluster.num_servers, False)
        for bad in ((G, share, compute, Y[0]),
                    (G, share, compute, Y.astype(np.float64)),
                    (G[:2], share, compute, Y),
                    (G.astype(np.float64), share, compute, Y),
                    (G, share[:2], compute, Y),
                    (G, share, compute.astype(np.int64), Y)):
            with pytest.raises(ValueError):
                tau.tau_stack(cluster, *bad, device="cpu")


def _pick_case(seed, hetero):
    cluster = ref_philly_cluster(6, seed=seed, **(HETERO if hetero else {}))
    jobs = ref_philly_workload(seed=seed, mix=((1, 4), (2, 2), (4, 3),
                                               (8, 2), (16, 1)))
    return cluster, jobs


RANKING_CASES = ("no_feasible", "no_fit", "idle_ties", "m_eq_S", "G_eq_N",
                 "signed_zeros")


class TestPickOrders:
    """K3: pool statistics and pick rankings, fuzzed over clock states."""

    @pytest.mark.parametrize("seed", [5, 6])
    def test_matches_reference_kernel_and_numpy(self, seed, x64,
                                                monkeypatch):
        ref_cluster, ref_jobs = _pick_case(seed, hetero=seed % 2 == 1)
        cluster, jobs = _carry(ref_cluster, ref_jobs)
        N = cluster.num_gpus
        rng = np.random.default_rng(seed)
        for trial in range(10):
            i = int(rng.integers(len(jobs)))
            nw = int(rng.integers(1, 20))
            U = np.round(rng.uniform(0, 30, size=(nw, N)), 3)
            if trial % 3 == 0:
                U[:, : N // 2] = 0.0          # idle GPUs: exact-tie loads
            th_lo = np.sort(rng.uniform(5, 40, size=nw))
            th_hi = th_lo + rng.uniform(0, 10, size=nw)
            rho_u = rng.uniform(0.5, 20, size=nw)
            pid = rng.integers(0, 2, size=nw)
            got = placement.pick_orders(cluster, U.copy(), th_lo, th_hi,
                                        rho_u, pid, jobs[i], device="cpu")
            monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 10**9)
            want_np = ref_kp.pick_orders(ref_cluster, U.copy(), th_lo,
                                         th_hi, rho_u, pid, ref_jobs[i])
            monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 0)
            want_k = ref_kp.pick_orders(ref_cluster, U.copy(), th_lo, th_hi,
                                        rho_u, pid, ref_jobs[i],
                                        use_kernel=True)
            for a, b, c in zip(want_np, want_k, got):
                assert np.array_equal(np.asarray(a), c), f"trial {trial}"
                assert np.array_equal(np.asarray(b), c), f"trial {trial}"

    def test_pool_stats_plain_tie_breaks(self):
        """best_srv is the first index among equal (slots left, -load);
        with no server fitting it is 0 and has_fit is False."""
        caps = torch.tensor([4, 4, 4], dtype=torch.int64)
        offsets = torch.tensor([0, 4, 8], dtype=torch.int64)
        U = torch.zeros((2, 12), dtype=torch.float64)
        U[0, 4:] = 1.0                        # servers 1 and 2 tie on load
        th = torch.tensor([2.0, 0.5], dtype=torch.float64)
        rho = torch.tensor([0.5, 1.0], dtype=torch.float64)
        pid = torch.zeros(2, dtype=torch.int64)
        gpu_server = torch.arange(3).repeat_interleave(4)
        c_lo, _, load, cnt, best, fit, order, ok = placement.pool_stats(
            U, th, th, rho, pid, 4, 4.0, offsets, caps, gpu_server)
        assert load.tolist() == [[0.0, 4.0, 4.0], [0.0, 0.0, 0.0]]
        assert cnt.tolist() == [[4, 4, 4], [0, 0, 0]]
        assert best.tolist() == [1, 0] and fit.tolist() == [True, False]
        assert c_lo.tolist() == [12, 0]
        # FA-FFP packs into server 1 (GPUs 4-7), the rest in id order;
        # with no feasible GPU every key is inf and the order is the ids.
        assert order.tolist() == [[4, 5, 6, 7, 0, 1, 2, 3, 8, 9, 10, 11],
                                  list(range(12))]
        assert ok.tolist() == [True, False]

    def test_packed_output_layout(self):
        """unpack_pool reads the layout the pool kernel writes: c_lo,
        c_hi, ok, order first (what pick_orders copies back), then
        best_srv, has_fit, load as float64 bits and cnt; the flags as
        bool bytes at the start of their words (the rest never read)."""
        B, N, S = 2, 3, 2
        load = torch.tensor([[1.5, -0.0], [2.25, 7.0]], dtype=torch.float64)
        packed = torch.tensor(
            [4, 5, 6, 7, -1, -1, 2, 0, 1, 1, 2, 0, 1, 0, -1, -1]
            + load.view(torch.int64).ravel().tolist() + [3, 2, 1, 0],
            dtype=torch.int64)
        assert packed.numel() == placement.pool_words(B, N, S)
        packed[4:6].view(torch.uint8)[:B] = torch.tensor([1, 0])  # ok
        packed[14:16].view(torch.uint8)[:B] = torch.tensor([0, 1])  # fit
        c_lo, c_hi, got_load, cnt, best, fit, order, ok = \
            placement.unpack_pool(packed, B, N, S)
        assert c_lo.tolist() == [4, 5] and c_hi.tolist() == [6, 7]
        assert ok.tolist() == [True, False]
        assert order.tolist() == [[2, 0, 1], [1, 2, 0]]
        assert best.tolist() == [1, 0] and fit.tolist() == [False, True]
        assert torch.equal(got_load, load)
        assert got_load[0, 1].item() == 0.0 and \
            torch.signbit(got_load[0, 1]).item()
        assert cnt.tolist() == [[3, 2], [1, 0]]

    def test_pool_rejects_rows_beyond_shared_memory(self):
        """A row whose servers overflow a block's shared memory raises
        (on every device) instead of launching."""
        S = 5000
        caps = torch.ones(S, dtype=torch.int64)
        f64 = torch.zeros(1, dtype=torch.float64)
        with pytest.raises(ValueError, match="shared memory"):
            placement.pool_stats(
                torch.zeros((1, S), dtype=torch.float64), f64, f64, f64,
                torch.zeros(1, dtype=torch.int64), 1, 1.0,
                torch.arange(S, dtype=torch.int64), caps,
                torch.arange(S, dtype=torch.int64))

    @pytest.mark.parametrize("equal_caps", [True, False])
    @pytest.mark.parametrize("case", RANKING_CASES)
    def test_rankings_match_reference_on_edge_cases(self, case, equal_caps,
                                                    x64, monkeypatch):
        """Both pickers mixed in one batch, on an equal-capacity and an
        unequal-capacity (Philly) cluster, against the reference's NumPy
        and Pallas paths: rows with no feasible GPU, no server fitting G,
        exact-tie idle clocks, an LBSGF prefix of every server, G = N and
        clocks of both zero signs."""
        ref_cluster = (RefCluster(capacities=(8,) * 5) if equal_caps
                       else ref_philly_cluster(6, seed=8))
        base = ref_philly_workload(seed=8, mix=((4, 1),))[0]
        N = ref_cluster.num_gpus
        caps = ref_cluster.capacities_array
        rng = np.random.default_rng(2 * RANKING_CASES.index(case)
                                    + equal_caps)
        nw = 12
        U = np.round(rng.uniform(0, 30, size=(nw, N)), 3)
        th_lo = np.sort(rng.uniform(5, 40, size=nw))
        th_hi = th_lo + rng.uniform(0, 10, size=nw)
        rho_u = rng.uniform(0.5, 20, size=nw)
        pid = np.arange(nw) % 2
        G, lam = 4, 1.0
        if case == "no_feasible":
            th_lo[::3] = 0.1                  # V >= rho_u >= 0.5
        elif case == "no_fit":
            G = int(caps.max()) + 1           # no server can hold the job
            th_lo += 30.0
        elif case == "idle_ties":
            U[:, rng.random(N) < 0.6] = 0.0
            U[1::2, : N // 2] = 5.0           # equal busy clocks
        elif case == "m_eq_S":
            lam = 1e6                         # lambda * G past every cap
        elif case == "G_eq_N":
            G = N
            th_lo[::2] = 1e3                  # every GPU feasible
            th_hi[::2] = 1e3
        elif case == "signed_zeros":
            U[:, rng.random(N) < 0.3] = 0.0
            U[:, rng.random(N) < 0.3] = -0.0
            th_lo[::4] = th_lo[::4] * 0.0
            rho_u[::4] = -0.0
        ref_job = dataclasses.replace(base, num_gpus=G, lam=lam)
        cluster, (job,) = _carry(ref_cluster, [ref_job])
        got = placement.pick_orders(cluster, U.copy(), th_lo, th_hi, rho_u,
                                    pid, job, device="cpu")
        monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 10**9)
        want_np = ref_kp.pick_orders(ref_cluster, U.copy(), th_lo, th_hi,
                                     rho_u, pid, ref_job)
        monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 0)
        want_k = ref_kp.pick_orders(ref_cluster, U.copy(), th_lo, th_hi,
                                    rho_u, pid, ref_job, use_kernel=True)
        for a, b, c in zip(want_np, want_k, got):
            assert np.asarray(a).dtype == c.dtype
            assert np.array_equal(np.asarray(a), c)
            assert np.array_equal(np.asarray(b), c)


class TestScoreProbes:
    """K4: Eq. (8) tau and rho-hat of probed candidates."""

    @pytest.mark.parametrize("hetero", [False, True])
    def test_matches_reference_kernel_and_numpy(self, hetero, x64,
                                                monkeypatch):
        ref_cluster, ref_jobs = _pick_case(7, hetero)
        cluster, jobs = _carry(ref_cluster, ref_jobs)
        S = cluster.num_servers
        rng = np.random.default_rng(17)
        for trial in range(8):
            i = int(rng.integers(len(jobs)))
            G = jobs[i].num_gpus
            C = int(rng.integers(1, 24))
            Y = np.zeros((C, S), dtype=np.int64)
            for c in range(C):
                for _ in range(G):
                    Y[c, rng.integers(S)] += 1
            p = rng.integers(0, 6, size=C).astype(np.float64)
            got = placement.score_probes(cluster, jobs[i], Y, p,
                                         device="cpu")
            monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 10**9)
            want_np = ref_kp.score_probes(ref_cluster, ref_jobs[i], Y, p)
            monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 0)
            want_k = ref_kp.score_probes(ref_cluster, ref_jobs[i], Y, p,
                                         use_kernel=True)
            for a, b, c in zip(want_np, want_k, got):
                assert np.array_equal(np.asarray(a), c), f"trial {trial}"
                assert np.array_equal(np.asarray(b), c), f"trial {trial}"

    @pytest.mark.parametrize("hetero", [False, True])
    @pytest.mark.parametrize("equal_caps", [True, False])
    def test_degradation_from_p_matches_reference(self, hetero, equal_caps,
                                                  x64, monkeypatch):
        """k = max(xi1 * p, 1), f and gamma = xi2 * n_srv now come from p
        inside the kernel's plain version: p at 0 (k clamped to 1),
        fractional and large, single-server rows (n_srv = 1) and
        one-candidate batches, against both reference paths."""
        if equal_caps:
            het = dict(gpu_speeds=(50.0, 12.5) * 20,
                       links=((1.25, "shared"), (1.25, "isolated")) * 2
                       + ((2.5, "shared"),)) if hetero else {}
            ref_cluster = RefCluster(capacities=(8,) * 5, **het)
        else:
            ref_cluster = ref_philly_cluster(6, seed=9,
                                             **(HETERO if hetero else {}))
        assert ref_cluster.is_heterogeneous == hetero
        ref_jobs = ref_philly_workload(seed=9, mix=((1, 2), (4, 2), (8, 2)))
        cluster, jobs = _carry(ref_cluster, ref_jobs)
        S = cluster.num_servers
        rng = np.random.default_rng(23 + 2 * hetero + equal_caps)
        for trial, C in enumerate((1, 7, 30)):
            i = trial % len(jobs)
            Y = rng.integers(0, 3, size=(C, S)) * (rng.random((C, S)) < 0.5)
            Y[::3] = 0
            Y[::3, rng.integers(S)] = jobs[i].num_gpus   # one server only
            Y[Y.sum(axis=1) == 0, 0] = 1
            p = np.concatenate([[0.0], rng.uniform(0, 9, size=C)])[:C]
            p[1::4] = np.round(p[1::4])
            got = placement.score_probes(cluster, jobs[i], Y, p,
                                         device="cpu")
            monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 10**9)
            want_np = ref_kp.score_probes(ref_cluster, ref_jobs[i], Y, p)
            monkeypatch.setattr(ref_kp, "DISPATCH_MIN_ROWS", 0)
            want_k = ref_kp.score_probes(ref_cluster, ref_jobs[i], Y, p,
                                         use_kernel=True)
            for a, b, c in zip(want_np, want_k, got):
                assert np.array_equal(np.asarray(a), c), f"C={C}"
                assert np.array_equal(np.asarray(b), c), f"C={C}"
