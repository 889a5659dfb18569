#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line), after the
per-launch floor (one in-place add on a one-element tensor):

  1. build -- compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
     sm_90a (one nvcc per source, in parallel) and print ptxas's
     register/shared-memory lines and the build seconds;
  2. kernels -- call each kernel's wrapper on card tensors at the §7
     shapes (S = 20 servers, N ~ 300 GPUs of ``philly_cluster(20,
     seed=1)``, B = C = 64 rows, J = 161 stack rows) and require
     ``torch.equal`` with its plain PyTorch version on the same inputs;
     time both with CUDA events; K1 and K2 also at the |J| = 1024 scale
     point's stack (C = 64, J = 1025, S = 32); the K3/K4 SASS counts
     (``DSETP``, ``DADD``, ...) printed.  The attention kernel K5 is held
     against its plain version within 2e-2 (bf16) and 2e-5 (float32) at
     the llama3.2-1b serving shape (B = 4, H = 32, K = 8, S = 1024,
     hd = 64, in the model layout the prefill hands it) and on small
     cases (window, softcap, non-causal, ragged S, kv_len, hd 32/128/256),
     each in both dtypes; its tiles per head dim and the tensor-core
     (``HMMA``) and asynchronous-copy (``LDGSTS``) instructions of its
     bf16 kernels in ``cuobjdump -sass`` are printed (no ``HMMA`` fails);
     timed in bf16 beside its plain version and
     ``F.scaled_dot_product_attention`` (the yardstick only: the port
     never calls it), and in float32;
  3. end to end -- ``run_scenario(..., device="cuda")`` on the §7 Philly
     setting (160 jobs) for {homogeneous, heterogeneous} x {incremental,
     batched}, each held bitwise against the port's ``device="cpu"`` run
     with the reference defaults; then the |J| = 1024 scale point (32
     servers, homogeneous, batched engine) held the same way.  The kernel
     launch counters are zeroed before each run and every kernel that run
     reaches must have launched; each run prints its calls and host
     seconds (per run and per call) inside ``pick_orders``,
     ``score_probes`` and ``tau_stack``.  Then one traced call of
     ``pick_orders``, of ``score_probes`` and of ``tau_stack``
     (torch.profiler) must make one HtoD copy, one DtoH copy and one
     kernel, and 50 traced and 200 untraced calls split a call into
     copies, launch, wait and host work;
  4. serving -- llama3.2-1b at full width (16 layers, d_model 2048, vocab
     128256), random weights from a seeded ``torch.Generator``, K5 on:
     float32 prefill (B = 2, S = 512) with K5 against K5 off (2e-4) and 16
     stepped decode positions against it (2e-2); bf16 prefill (B = 4,
     S = 1024) timed and compared with K5 off, and both held against a
     float32 K5-off prefill of the same tokens: K5 on may be no farther
     from it than 1.5x K5 off's distance; the device's busy share of
     a prefill and of a decode window (torch.profiler); then the
     ``repro_torch.launch.serve`` CLI loop at its defaults (batch 4, prompt
     16, 32 tokens).  K5 must launch once per layer of every K5 prefill;
  5. mLSTM kernel -- K6 against its plain version at xlstm-350m's prefill
     shape (B = 4, H = 4, S = 1024, hd = 512, in the model layout the
     prefill hands it) within 2e-4 in float32 and 3e-2 with bf16 inputs,
     and on small cases (every head dim, ragged S, S at the edges of its
     tiles from 1 to 1000, BH = 1 and 16, a view one element off its
     allocation); on two near-cancelling cases (|sum S| far below its
     terms) the kernel within 2e-4 of the float64 plain version, its
     distance and the float32 plain version's printed; the fp32 FMA
     (``FFMA``), asynchronous-copy (``LDGSTS``) and tensor-core (``HMMA``)
     instructions of its kernels in ``cuobjdump -sass`` printed (no
     ``FFMA`` fails); timed beside its plain version (no PyTorch call
     computes this function), its bound that of fp32 on the CUDA cores,
     with that of 3xTF32 on the tensor cores beside it;
  6. xlstm -- xlstm-350m at full width (24 layers, d_model 1024, vocab
     50304), random weights from a seeded ``torch.Generator``, K6 on:
     a float32 prefill (B = 2, S = 1024) in which every mLSTM block's K6
     output is held against the same block with K6 off (2e-4) and every
     block's first 16 positions against 16 steps of its decode recurrence
     (2e-2), on that block's own inputs; the whole prefill's K6 on vs off
     difference and its change under a one-ulp nudge of the embeddings
     are printed, not gated (the random-init stack amplifies rounding to
     O(1) logits); bf16 prefill (B = 4,
     S = 1024) timed with K6 on and off, their logits compared, the
     mLSTM / sLSTM split of its wall time and the device's busy share;
     then the serve CLI at its defaults.  K6 must launch exactly once per
     mLSTM block (18) of every K6 prefill; the profiled prefill prints
     K6's device time;
  7. RMSNorm and SwiGLU kernels -- K7 and K8 against their plain versions
     in float32 (2e-5) and bf16 (2e-2) at the reference tests' shapes
     (K7 rows x d (8, 128), (256, 512), (1024, 4096), (64, 3584); K8
     M x K x N (128, 512, 128), (256, 1024, 512), (128, 256, 384)), one
     ``wgmma`` tile of K8 (64, 16, 64) and (64, 64, 64), ragged
     shapes (K7 (100, 3000), (37, 1001), rows of several warps (16, 16384),
     (4, 40000), (3, 9001) and a strided view; K8 K not a multiple of 64
     (128, 300, 256), (128, 2047, 128), ragged tiles (100, 300, 200),
     (129, 512, 136), a column-slice weight and misaligned views, which
     the bf16 wrapper copies for TMA), the decode shape (4 rows)
     and K8 with |gate| ~ 100; timed at llama3.2-1b's bf16 prefill shape
     (B = 4 x S = 1024 tokens, d_model 2048, d_ff 8192) beside their plain
     versions, ``F.rms_norm`` for K7 (the yardstick only: the port never
     calls it) and, for K8, which no single PyTorch call computes, the
     three-call cuBLAS composite ``F.silu(x @ Wg) * (x @ Wu)``; the bf16
     K8's tensor-core (``HGMMA``) and TMA (``UTMALDG``) instructions in
     ``cuobjdump -sass`` are printed (no ``HGMMA`` fails); the float32 K8
     (the CUDA-core kernel) is timed at (1024, 2048, 8192);
  8. entry points -- ``ops.rmsnorm`` and ``ops.swiglu`` (the reference's
     public entry points of K7 and K8; no model of either package calls
     them) on llama3.2-1b's own activations at full width: a float32
     prefill (B = 2, S = 512) and a bf16 prefill (B = 4, S = 1024) in which
     every norm input (ln1, ln2 of 16 layers and ln_f: 33 K7 launches) and
     every MLP input (16 K8 launches, the weights cast as ``mlp`` casts
     them) also goes through the entry point, held against its plain
     version (2e-5 f32, 2e-2 bf16); the distance to the model's in-line
     norm and gate math is printed, not gated.  The model's own results
     flow on, so the logits must be ``torch.equal`` to an unpatched
     prefill's.  One more checked bf16 prefill runs under torch.profiler
     for its device busy time and K8's part of it.
  9. service -- the scheduler service (``repro_torch.service``) on the
     card, where every decision's candidates are priced in one stack by K1
     (homogeneous) or K2 (heterogeneous), each run held bitwise against
     the port's ``device="cpu"`` run with the reference defaults: (a) the
     §7 online stream (``philly_cluster(20, seed=1)``, the 160-job
     workload as ``poisson_arrivals(rate=0.5, seed=1)``), homogeneous and
     heterogeneous, drained by ``SchedulerService(..., device="cuda")``
     for sjf-bco, sjf-bco-dynamic, gadget-elastic and wang-ca, also held
     against ``schedule_arrivals`` and ``run_online(..., device="cuda")``;
     (b) the service benchmark's traffic at |J| = 1024 on 64 servers
     (Poisson gaps of mean 2 slots; waves of 32 every 64 slots) under
     sjf-bco: decisions/s, p50/p99/max decision ms and drain wall, card
     beside CPU, and K1 launches a decision; (c) the Poisson drain against
     a sqlite journal (appends/s), that journal cut in half, recovered on
     the card (U/R bitwise equal to the CPU's recovery of the same cut),
     the rest resubmitted and drained equal to the uncut drain; the same
     for sjf-bco-dynamic's §7 journal, which holds evict records; (d)
     ``run_scenario(Scenario(policy="sjf-bco-dynamic"), device="cuda")``
     on the §7 setting, {hom, het} x {incremental, batched}; (e) the §6
     certificate (``theory.report``) of the §7 homogeneous sjf-bco run,
     equal and certified on both devices, and ``replay_trace`` of
     ``examples/sample_trace.csv`` into a card daemon.  The counters are
     zeroed before each run; K1 must launch in every homogeneous drain and
     K2 in every heterogeneous one.
 10. training -- llama3.2-1b at full width (float32 params, bf16 compute,
     random weights from a seeded ``torch.Generator``): (a) the
     ring-all-reduce on a [4, d] float32 buffer of its gradient size, in
     place, every row ``torch.equal`` to a plain loop of adds in the
     ring's order written here, within 2e-5 of ``torch.sum`` over the
     workers, 2(w - 1) steps and ``exchange_bytes_per_worker`` bytes a
     worker, ms a ring; (b) ``make_rar_train_step`` at w = 4, global batch
     8, seq 256, 5 steps: each loss finite and every ring row the same
     bits, s a step and tokens/s, a step split into the workers' fwd+bwd,
     the ring and AdamW, peak device memory, the device's idle share of
     one step (torch.profiler), and the ring-averaged gradient of step 0
     within a relative L2 gap of 1e-2 of the single-program gradient of
     the concatenated batch; (c) the ``repro_torch.launch.train`` CLI at
     full width for 3 RAR steps with one checkpoint, reloaded bitwise; (d)
     ``repro_torch.launch.sched_launch`` (4 GPUs, 2 servers, 3 jobs, 2
     steps, then at its defaults: 8 GPUs, 2 servers, 6 jobs, 4 steps, so
     every family of its pool trains, reduced) on the card, its schedule
     and simulated run bitwise equal to the same run on the CPU, each
     job's losses finite and the kernel launches of its scheduling.  No
     kernel runs in training: the kernels have no backward, and the
     models train with their kernel branches off, as the reference's do.
 11. families -- from an empty allocator (its bytes printed), K5 first at
     the three new serving shapes in bf16 (deepseek-moe-16b (4, 16, 16,
     1024, 128), hymba-1.5b (4, 25, 5, 1024, 64) with its 1024 window,
     whisper-tiny's encoder (2, 6, 6, 1500, 64) non-causal) within 2e-2
     of its plain version, timed beside it and
     ``F.scaled_dot_product_attention``, with its bound; then three
     models at full width and depth, random weights from a seeded
     ``torch.Generator``, K5 on.  (a) deepseek-moe-16b (16.4e9 float32
     params, 61 GiB): a float32 prefill (B = 2, S = 256) in which every
     block also runs with K5 off on its own inputs, within 2e-4 over the
     tokens both runs route to the same experts and keep (the routed-
     differently share of (token, MoE layer) pairs at most 1e-3); 16
     stepped decode positions against a no-drop prefill (capacity factor
     = n_experts: a dropping prefill and a 2-token decode keep different
     tokens) within 2e-2 over the positions routed alike; the whole
     prefill's K5 on vs off difference printed; a bf16 prefill (B = 4, S
     = 1024) timed with K5 on and off, both distances to a float32 K5-off
     prefill printed (routing flips dominate both), ``moe_apply``'s share
     of the wall and the device's busy share; its params freed before the
     serve CLI builds its own.  (b) hymba-1.5b: float32 prefill (B = 2, S
     = 2048, so the 1024 windows bite) K5 on vs off (2e-4) and 16 stepped
     decode positions (Mamba's recurrence against the scan, 2e-2); bf16
     prefill (B = 4, S = 1024) timed, K5 on within 1.5x K5 off of a
     float32 prefill, its attention / Mamba split and busy share.  (c)
     whisper-tiny built with max_seq 448: float32 frames [2, 1500, 384]
     and decoder S = 256, encode + prefill K5 on vs off (2e-4), decode
     with the encoder output in the cache vs prefill (2e-2); bf16 timed
     with the 1.5x gate.  Each model's serve CLI at its defaults (whisper
     with seeded frames), its peak device memory; K5 must launch exactly
     28, 32 and 4 non-causal + 4 causal times a prefill (never for
     cross-attention; 4 per whisper encoder run alone).

 12. dry-run -- the production-mesh dry-run (``launch/dryrun.py``): (a)
     full-width pairs as DTensor steps over a fake process group on
     fake CUDA tensors (llama3.2-1b train_4k / prefill_32k / decode_32k,
     deepseek-moe-16b train_4k, hymba-1.5b long_500k and decode_32k,
     whisper-tiny train_4k, xlstm-350m decode_32k and prefill_32k and
     internvl2-1b prefill_32k naive and optimized on 16x16; llama3-405b
     and xlstm-350m train_4k on 2x16x16), each row's per-device GiB
     against 80, FLOPs, bytes, collective and DCN bytes, bottleneck and
     seconds printed; every pair must run and count FLOPs, bytes and
     collective bytes, the 2x16x16 train steps must send DCN bytes,
     xlstm-350m train_4k must count at least half of 6 N D over its 512
     devices (its sLSTM scans run as one op each,
     ``models/slstm_scan.py``), naive internvl2-1b must hold every param
     byte on a device and the optimized run at most 1/16 of them.
     (b) llama3.2-1b on one real rank (nccl, world size 1, a 1x1 mesh)
     at a batch that fits 80 GB, on fake and on real CUDA tensors: the
     FLOPs and collective counts equal, the fake peak above the
     arguments within 10% of the card's ``max_memory_allocated`` above
     them; the measured wall and the roofline share max(t_compute,
     t_memory) / wall printed.  No kernel launches (the models run with
     their kernel branches off).

float32 matrix products run in full float32 throughout
(``torch.backends.cuda.matmul.allow_tf32 = False``, set in ``main``): the
float32 gates compare K5 and K8 with cuBLAS products.

The last lines are the per-kernel JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12         # H100 SXM FP64 outside the tensor cores
FP32_OPS_PER_S = 67e12         # H100 SXM FP32 outside the tensor cores
TF32_TC_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
# K5 at the llama3.2-1b serving shape: batch, q heads, kv heads, seq, hd.
SERVE_ATTN = (4, 32, 8, 1024, 64)
# K6 at the xlstm-350m prefill shape: batch, heads, seq, hd.
XLSTM_MLSTM = (4, 4, 1024, 512)
# K7 and K8 at the llama3.2-1b bf16 prefill: tokens (B 4 x S 1024),
# d_model, d_ff.
SERVE_MLP = (4096, 2048, 8192)
# The §7 heterogeneous variant: two speed tiers, shared vs isolated uplinks.
HETERO = dict(speed_tiers=((50.0, 0.5), (12.5, 0.5)),
              link_classes=((1.25, "shared", 0.5), (1.25, "isolated", 0.5)))
PHILLY_MIX = ((1, 80), (2, 14), (4, 26), (8, 30), (16, 8), (32, 2))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def mix_for(total: int) -> tuple[tuple[int, int], ...]:
    """The §7 Philly mix (160 jobs) scaled to ``total`` jobs, keeping the
    job-size shares; the remainder lands on the largest fractional parts."""
    base = sum(c for _, c in PHILLY_MIX)
    exact = [(g, total * c / base) for g, c in PHILLY_MIX]
    counts = [int(x) for _, x in exact]
    order = sorted(range(len(exact)), key=lambda i: exact[i][1] - counts[i],
                   reverse=True)
    for i in order[: total - sum(counts)]:
        counts[i] += 1
    return tuple((g, c) for (g, _), c in zip(exact, counts) if c > 0)


def time_ms(torch, fn, reps: int = 200) -> float:
    """Mean ms per call of ``fn`` on the card: CUDA events around ``reps``
    back-to-back calls, queued behind a sleep kernel so that host enqueue
    gaps do not count where the calls do not synchronise."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def columnar_stack(np, cluster, jobs, C, rng, put):
    """A columnar batched-engine stack: per candidate, the placed jobs in
    its own row order plus the probed candidate row (J = |jobs| + 1),
    each on a random GPU set; per-candidate [C, J] terms.  Returns the
    four card tensors and their bytes."""
    import torch

    from repro_torch.core.contention import _job_terms
    S, N = cluster.num_servers, cluster.num_gpus
    G, share, compute = _job_terms(jobs)
    J = len(jobs) + 1
    Y = np.zeros((C, J, S), dtype=np.int64)
    G2 = np.zeros((C, J), dtype=np.int64)
    sh2, cp2 = np.zeros((C, J)), np.zeros((C, J))
    for c in range(C):
        perm = np.concatenate([rng.permutation(len(jobs)),
                               [rng.integers(len(jobs))]])
        for r, j in enumerate(perm):
            gpus = rng.choice(N, size=G[j], replace=False)
            Y[c, r] = np.bincount(cluster.gpu_server[gpus], minlength=S)
        G2[c], sh2[c], cp2[c] = G[perm], share[perm], compute[perm]
    return ((put(Y, torch.int64), put(G2, torch.int64),
             put(sh2, torch.float64), put(cp2, torch.float64)),
            Y.nbytes + G2.nbytes + sh2.nbytes + cp2.nbytes)


def tau_scale_point(torch, np, rt, dev) -> None:
    """K1 and K2 at the |J| = 1024 scale point's stack shape (J = 1025
    stack rows, S = 32 servers, C = 64 candidates): ``torch.equal`` to
    their plain versions, timed beside them."""
    from repro_torch.kernels import tau

    def put(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    hom = rt.philly_cluster(32, seed=1)
    het = rt.philly_cluster(32, seed=1, **HETERO)
    jobs = rt.philly_workload(seed=1, mix=mix_for(1024))
    stack, _ = columnar_stack(np, hom, jobs, 64, np.random.default_rng(2),
                              put)
    scal = dict(xi1=hom.xi1, xi2=hom.xi2, alpha=hom.alpha,
                b_intra=hom.b_intra)
    het_t = tau.cluster_tensors(het, dev)
    het_terms = (het_t["speed_floor"], het_t["uplink_sh"],
                 het_t["uplink_iso"])
    hom_kw = dict(scal, b_inter=hom.b_inter, gpu_speed=hom.gpu_speed)
    for name, kern, plain in (
            ("tau", lambda: tau.tau_stack_hom(*stack, **hom_kw),
             lambda: tau.tau_stack_hom_plain(*stack, **hom_kw)),
            ("tau_het", lambda: tau.tau_stack_het(*stack, *het_terms, **scal),
             lambda: tau.tau_stack_het_plain(*stack, *het_terms, **scal))):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"kernel {name} disagrees with its plain version at the "
                 "scale-point stack")
        ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain, reps=50)
        print(f"kernel {name} at the scale-point stack {tuple(stack[0].shape)}"
              f": torch.equal to plain, {ms:.6f} ms/launch, plain "
              f"{plain_ms:.6f} ms", flush=True)


def pool_ops(B: int, N: int, S: int) -> int:
    """K3's float64 operations over B rows of N GPUs on S servers: 8 a GPU
    (the charged clock and both pool compares, the server sum and its
    feasibility compare, the sort key), a comparison sort's N
    ceil(log2 N) key compares of two operations each, and the LBSGF
    server keys and their sort (counted for every row)."""
    log = max(1, (N - 1).bit_length())
    slog = max(1, (S - 1).bit_length())
    return B * (8 * N + 2 * N * log + S + 2 * S * slog)


def kernel_phase(torch, np, rt, dev) -> list[dict]:
    """Each kernel against its plain version at the §7 shapes."""
    from repro_torch.kernels import placement, tau

    rng = np.random.default_rng(1)
    hom = rt.philly_cluster(20, seed=1)
    het = rt.philly_cluster(20, seed=1, **HETERO)
    jobs = rt.philly_workload(seed=1)
    S, N = hom.num_servers, hom.num_gpus
    C, B = 64, 64

    def put(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    stack, stack_in = columnar_stack(np, hom, jobs, C, rng, put)
    J = len(jobs) + 1
    stack_out = C * J * 3 * 8
    tau_ops = C * J * S * 6 + C * J * 14
    scal = dict(xi1=hom.xi1, xi2=hom.xi2, alpha=hom.alpha,
                b_intra=hom.b_intra)
    het_t = tau.cluster_tensors(het, dev)
    het_terms = (het_t["speed_floor"], het_t["uplink_sh"],
                 het_t["uplink_iso"])
    hom_kw = dict(scal, b_inter=hom.b_inter, gpu_speed=hom.gpu_speed)

    # Pool statistics and pick rankings over B work rows of busy-time
    # clocks (idle GPUs included, so equal loads tie), FA-FFP and LBSGF
    # rows mixed, an 8-GPU job.
    U = np.round(rng.uniform(0, 400, size=(B, N)), 3)
    U[:, rng.choice(N, size=N // 3, replace=False)] = 0.0
    th_lo = np.sort(rng.uniform(100, 700, size=B))
    ct = tau.cluster_tensors(hom, dev)
    pool_args = (put(U, torch.float64), put(th_lo, torch.float64),
                 put(th_lo + rng.uniform(0, 50, size=B), torch.float64),
                 put(rng.uniform(5, 150, size=B), torch.float64),
                 put(rng.integers(0, 2, size=B), torch.int64), 8, 8.0,
                 ct["offsets"], ct["caps"], put(hom.gpu_server, torch.int64))
    pool_in = U.nbytes + 4 * B * 8 + 2 * S * 8 + N * 8
    pool_out = 8 * (3 * B + B * N + 2 * B * S) + 2 * B   # flags 1 byte

    # Probe scoring of B candidate rows of an 8-GPU job.
    Yp = np.stack([np.bincount(het.gpu_server[rng.choice(N, 8, False)],
                               minlength=S) for _ in range(B)])
    p = rng.integers(0, 8, size=B).astype(np.float64)
    job = jobs[0]
    w = float(job.num_gpus)
    sh_j = (job.grad_size / w) * (w - 1.0) if w > 1 else 0.0
    score_args = (put(Yp, torch.int64), put(p, torch.float64), *het_terms,
                  (2.0 * sh_j, sh_j, sh_j / het.gpu_speed,
                   job.dt_fwd * job.batch + job.dt_bwd, float(job.iters)))
    score_kw = dict(hetero=True, xi1=het.xi1, xi2=het.xi2, alpha=het.alpha,
                    b_inter=het.b_inter, b_intra=het.b_intra)
    score_in = Yp.nbytes + B * 8 + 3 * S * 8

    cases = [
        ("tau", "tau_stack_hom", "kernels/tau.py:75",
         lambda: tau.tau_stack_hom(*stack, **hom_kw),
         lambda: tau.tau_stack_hom_plain(*stack, **hom_kw),
         stack_in, stack_out, tau_ops),
        ("tau_het", "tau_stack_het", "kernels/tau.py:40",
         lambda: tau.tau_stack_het(*stack, *het_terms, **scal),
         lambda: tau.tau_stack_het_plain(*stack, *het_terms, **scal),
         stack_in + 3 * S * 8, stack_out, tau_ops + C * J * S * 3),
        ("pool", "pool_stats", "kernels/placement.py:195",
         lambda: placement.pool_stats(*pool_args),
         lambda: placement.pool_stats_plain(*pool_args),
         pool_in, pool_out, pool_ops(B, N, S)),
        ("score", "score_rows", "kernels/placement.py:212",
         lambda: placement.score_rows(*score_args, **score_kw),
         lambda: placement.score_rows_plain(*score_args, **score_kw),
         score_in, 2 * B * 8, B * S * 4 + B * 16),
    ]
    rows = []
    for name, fn, replaces, kern, plain, n_in, n_out, n_ops in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"kernel {name} disagrees with its plain version")
        err = max((float((g.double() - w.double()).abs().max())
                   for g, w in zip(got, want)
                   if g.is_floating_point() and g.numel()), default=0.0)
        ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
        bytes_ms = (n_in + n_out) / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP64_OPS_PER_S * 1e3
        source = ("src/repro_torch/kernels/csrc/tau.cu" if name.startswith(
            "tau") else "src/repro_torch/kernels/csrc/placement.cu")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"src/repro/{replaces}", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "bytes": n_in + n_out, "entry": fn,
            "equal": True})
        print(f"kernel {name}: torch.equal to plain, max_abs_err {err}, "
              f"{ms:.6f} ms/launch, plain {plain_ms:.6f} ms, bytes "
              f"{n_in + n_out}, bound {max(bytes_ms, ops_ms):.6f} ms",
              flush=True)
    return rows


ENTRY_POINTS = ("pick_orders", "score_probes", "tau_stack")


def entry_points(rec) -> tuple[dict, dict]:
    """Host wall seconds and calls of each kernel-backed entry point
    (``pick_orders``, ``score_probes``, ``tau_stack``) in ``rec``, a
    ``repro_torch.obs`` recording: its ``kernel.<name>`` spans, which
    hold the copies to and from the card, the launches and the waits on
    their results."""
    spent = dict.fromkeys(ENTRY_POINTS, 0.0)
    calls = dict.fromkeys(ENTRY_POINTS, 0)
    for name, t0, t1 in rec.intervals():
        entry = name.removeprefix("kernel.")
        if entry in spent:
            spent[entry] += (t1 - t0) / 1e9
            calls[entry] += 1
    return spent, calls


def print_entry_points(spent: dict, calls: dict, t_card: float) -> None:
    """One run's host seconds inside each entry point, per run and per
    call, and the seconds elsewhere."""
    parts = [f"{n} {calls[n]} calls {spent[n]:.6f} s "
             f"({spent[n] / calls[n] * 1e3 if calls[n] else 0.0:.6f} ms/call)"
             for n in ENTRY_POINTS]
    print(f"  card run host seconds inside the kernel entry points: "
          f"{'; '.join(parts)}; elsewhere "
          f"{t_card - sum(spent.values()):.6f}", flush=True)


def entry_point_copies(torch, np, rt, dev, gate: bool = True) -> None:
    """One ``pick_orders``, one ``score_probes`` and one ``tau_stack``
    call on the card under torch.profiler: the HtoD and DtoH copies and
    kernels each makes.  The tracer can lose device events but never adds
    any, so with ``gate`` a traced call showing more than one of a kind
    fails, and so does one that shows no single call with one of each in
    five tries.  Then the
    split of a call from 50 traced calls: device ms of its copies and
    kernel, host ms in the CUDA runtime's copy, launch and wait calls,
    and the mean wall ms of 200 untraced calls, of which the rest is host
    work (packing, unpacking, Python).  Shapes: the scale point's cluster
    (32 servers, 524 GPUs), 64 work rows, an 8-GPU job, both pickers; 64
    heterogeneous candidates of it; a homogeneous stack of 64 candidates
    of 161 jobs with per-candidate terms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import placement, tau
    rng = np.random.default_rng(5)
    cluster = rt.philly_cluster(32, seed=1)
    het = rt.philly_cluster(32, seed=1, **HETERO)
    job = next(j for j in rt.philly_workload(seed=1) if j.num_gpus == 8)
    N, S, B = cluster.num_gpus, cluster.num_servers, 64
    U = np.round(rng.uniform(0, 400, size=(B, N)), 3)
    U[:, rng.random(N) < 0.3] = 0.0
    th_lo = rng.uniform(100, 700, size=B)
    pick = (cluster, U, th_lo, th_lo + rng.uniform(0, 50, size=B),
            rng.uniform(5, 150, size=B), rng.integers(0, 2, size=B), job)
    Y = np.stack([np.bincount(het.gpu_server[rng.choice(N, 8, False)],
                              minlength=S) for _ in range(B)])
    p = rng.integers(0, 8, size=B).astype(np.float64)
    C, J = 64, 161
    stack = (rng.integers(1, 9, (C, J)), rng.uniform(0.1, 10.0, (C, J)),
             rng.uniform(1, 5, (C, J)),
             rng.integers(1, 5, (C, J, S)) * (rng.random((C, J, S)) < 0.1))
    calls = (("pick_orders", lambda: placement.pick_orders(*pick)),
             ("score_probes", lambda: placement.score_probes(het, job, Y, p)),
             ("tau_stack", lambda: tau.tau_stack(cluster, *stack)))

    def traced(fn, reps):
        """(device events as (kind, ms), CUDA runtime host ms by name) of
        ``reps`` calls, traced after a warm-up step of as many calls."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events, api = [], {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith("ProfilerStep"):
                    continue
                kind = ("HtoD" if e.name.startswith("Memcpy HtoD") else
                        "DtoH" if e.name.startswith("Memcpy DtoH") else
                        "kernel")
                events.append((kind, e.time_range.elapsed_us() / 1e3))
            elif e.name.startswith("cuda"):
                api[e.name] = api.get(e.name, 0.0) + e.cpu_time_total / 1e3
        return events, api

    for name, fn in calls:
        fn()                                   # per-cluster state, build
        torch.cuda.synchronize()
        for attempt in range(5):
            events, _ = traced(fn, 1)
            counts = {k: sum(e[0] == k for e in events)
                      for k in ("HtoD", "DtoH", "kernel")}
            print(f"entry point {name}: one traced call makes {counts} "
                  f"(torch.profiler, try {attempt + 1})", flush=True)
            if gate and max(counts.values()) > 1:
                fail(f"{name}: one call makes {counts}, more than one of "
                     "a kind")
            if set(counts.values()) == {1}:
                break
        else:
            if gate:
                fail(f"{name}: no traced call showed one HtoD copy, one "
                     "DtoH copy and one kernel")
        events, api = traced(fn, 50)
        n = max(1, sum(e[0] == "kernel" for e in events))
        dev_ms = {}
        for kind, ms in events:
            dev_ms[kind] = dev_ms.get(kind, 0.0) + ms / n
        api = {k: v / n for k, v in api.items()}
        reps = 200
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) / reps * 1e3
        copy_ms = api.get("cudaMemcpyAsync", 0.0)
        launch_ms = api.get("cudaLaunchKernel", 0.0)
        wait_ms = api.get("cudaStreamSynchronize", 0.0)
        print(f"entry point {name}: {ms:.6f} ms/call wall ({reps} "
              f"untraced calls, B {B}, N {N}, S {S}); per traced call "
              f"(means over the {n} of 50 whose kernel was traced): device "
              f"{ {k: round(v, 6) for k, v in dev_ms.items()} } ms; host in "
              f"CUDA runtime: copies {copy_ms:.6f}, launch {launch_ms:.6f}, "
              f"wait {wait_ms:.6f} ms (all: "
              f"{ {k: round(v, 6) for k, v in api.items()} }); host work "
              f"(wall less those) {ms - copy_ms - launch_ms - wait_ms:.6f} "
              "ms", flush=True)


def device_profile(torch, label: str, fn, wall_s: float) -> None:
    """Device busy time of one more card run ``fn()`` under torch.profiler
    (CUDA activity only), against the unprofiled wall seconds ``wall_s``
    of the same run: the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    if not rows:
        print(f"device profile of {label}: the profiler recorded no device "
              "time (not measured)")
        return
    print(f"device profile of {label}: device busy "
          f"{busy_s:.6f} s of {wall_s:.6f} s wall, idle share "
          f"{1.0 - busy_s / wall_s:.6f}", flush=True)
    for us, count, key in rows[:8]:
        print(f"  device {us / 1e3:.3f} ms in {count} x {key[:70]}")


def same_schedule(a, b) -> bool:
    return (a.theta == b.theta and a.kappa == b.kappa
            and a.est_makespan == b.est_makespan
            and a.max_busy_time == b.max_busy_time
            and len(a.assignment) == len(b.assignment)
            and all(j1 == j2 and bool((g1 == g2).all())
                    for (j1, g1), (j2, g2) in zip(a.assignment, b.assignment))
            and bool((a.est_start == b.est_start).all())
            and bool((a.est_finish == b.est_finish).all()))


def end_to_end_phase(torch, rt, kernels, totals: dict) -> None:
    """§7 runs and the scale point, each on the card vs on the CPU."""
    from repro_torch import obs
    from repro_torch.core.contention import tau_backend

    walls = {}
    expect = {("hom", "incremental"): ("pool",),
              ("hom", "batched"): ("pool", "tau"),
              ("het", "incremental"): ("pool", "score"),
              ("het", "batched"): ("pool", "tau_het")}
    for (kind, engine), needs in expect.items():
        spec = rt.Scenario(
            cluster=rt.ClusterSpec(num_servers=20, seed=1,
                                   **(HETERO if kind == "het" else {})),
            workload=rt.WorkloadSpec(seed=1), policy="sjf-bco",
            policy_params=(("engine", engine),), horizon=1200)
        kernels.reset_launch_counts()
        obs.start()
        t0 = time.perf_counter()
        card = rt.run_scenario(spec, device="cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        counts = kernels.launch_counts()
        in_kernels, in_calls = entry_points(obs.stop())
        walls[(kind, engine)] = (spec, t_card)
        t0 = time.perf_counter()
        host = rt.run_scenario(spec, device="cpu")
        t_host = time.perf_counter() - t0
        label = f"§7 {kind} {engine}"
        if not same_schedule(card.schedule, host.schedule):
            fail(f"{label}: the card's schedule differs from the CPU's")
        if (card.sim.makespan, card.sim.avg_jct) != \
                (host.sim.makespan, host.sim.avg_jct):
            fail(f"{label}: the card's simulation differs from the CPU's")
        for name in needs:
            if counts[name] <= 0:
                fail(f"{label}: kernel {name} was never launched")
        for name, n in counts.items():
            totals[name] += n
        print(f"{label}: bitwise equal to the CPU run; theta "
              f"{card.schedule.theta} kappa {card.schedule.kappa} makespan "
              f"{card.sim.makespan} avg_jct {card.sim.avg_jct}; card "
              f"{t_card:.3f} s, cpu {t_host:.3f} s; launches {counts}",
              flush=True)
        print_entry_points(in_kernels, in_calls, t_card)

    cluster = rt.philly_cluster(32, seed=1)
    jobs = rt.philly_workload(seed=1, mix=mix_for(1024))
    base = dict(cluster=cluster, jobs=jobs, horizon=1200)
    kernels.reset_launch_counts()
    obs.start()
    t0 = time.perf_counter()
    with tau_backend("kernel", "cuda"):
        card = rt.get_policy("sjf-bco")(rt.ScheduleRequest(**base, params={
            "engine": "batched", "placement": "columnar",
            "columnar_backend": "kernel", "device": "cuda"}))
    card_sim = rt.simulate(cluster, jobs, card.assignment)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    counts = kernels.launch_counts()
    in_kernels, in_calls = entry_points(obs.stop())
    t0 = time.perf_counter()
    host = rt.get_policy("sjf-bco")(rt.ScheduleRequest(**base))
    host_sim = rt.simulate(cluster, jobs, host.assignment)
    t_host = time.perf_counter() - t0
    if not same_schedule(card, host) or \
            (card_sim.makespan, card_sim.avg_jct) != \
            (host_sim.makespan, host_sim.avg_jct):
        fail("scale point: the card's run differs from the CPU's")
    for name in ("pool", "tau"):
        if counts[name] <= 0:
            fail(f"scale point: kernel {name} was never launched")
    for name, n in counts.items():
        totals[name] += n
    print(f"scale |J|={len(jobs)} S={cluster.num_servers} batched: bitwise "
          f"equal to the CPU run; theta {card.theta} kappa {card.kappa} "
          f"makespan {card_sim.makespan}; card {t_card:.3f} s, cpu "
          f"{t_host:.3f} s; launches {counts}", flush=True)
    print_entry_points(in_kernels, in_calls, t_card)
    spec, wall = walls[("hom", "batched")]
    device_profile(torch, "the §7 homogeneous batched run",
                   lambda: rt.run_scenario(spec, device="cuda"), wall)


def flash_phase(torch, np, dev) -> dict:
    """K5 against its plain version on the card, at the serving shape in
    bf16 and float32 and on small cases; times at the serving shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    def model_layout(B, S, H, K, hd, dtype, seed, Skv=None):
        """q [B,S,H,hd], k/v [B,Skv,K,hd] as the prefill makes them, handed
        to the kernel as [B, heads, S, hd] views (what ops does)."""
        rng = np.random.default_rng(seed)
        return [torch.tensor(rng.standard_normal((B, n, heads, hd)),
                             dtype=torch.float32, device=dev).to(dtype)
                .transpose(1, 2)
                for n, heads in ((S, H), (Skv or S, K), (Skv or S, K))]

    def check(label, q, k, v, tol, **kw):
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"K5 {label}: max abs err {err} against its plain version "
                 f"exceeds {tol}")
        print(f"kernel flash_attention {label}: within {tol} of plain, max "
              f"abs err {err}", flush=True)
        return err

    B, H, K, S, hd = SERVE_ATTN
    bf16 = model_layout(B, S, H, K, hd, torch.bfloat16, seed=1)
    err = check(f"serving shape {SERVE_ATTN} bf16", *bf16, 2e-2)
    check(f"serving shape {SERVE_ATTN} float32",
          *model_layout(B, S, H, K, hd, torch.float32, seed=1), 2e-5)
    small = [
        ("window 32", (2, 256, 8, 2, 64), dict(window=32)),
        ("window 300", (2, 512, 8, 2, 64), dict(window=300)),
        ("softcap 50", (2, 256, 8, 8, 64), dict(softcap=50.0)),
        ("non-causal Sq 128 Skv 256", (2, 128, 4, 2, 64, 256),
         dict(causal=False)),
        ("ragged S 200 GQA", (2, 200, 8, 2, 64), {}),
        ("kv_len 150 of 192", (1, 192, 4, 4, 64), dict(kv_len=150)),
        ("hd 32", (2, 256, 4, 2, 32), {}),
        ("hd 128", (1, 320, 4, 1, 128), {}),
        ("hd 256 window 64", (1, 256, 2, 2, 256), dict(window=64)),
    ]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        name = str(dtype).rsplit(".", 1)[-1]
        for label, (b, s, h, kh, d, *skv), kw in small:
            check(f"{label} {name}", *model_layout(
                b, s, h, kh, d, dtype, seed=s, Skv=skv[0] if skv else None),
                tol, **kw)
    for d in fa.HEAD_DIMS:
        print(f"kernel flash_attention hd {d}: (BQ, BK) = "
              f"{fa.tiles(d, torch.bfloat16)} bf16 (tensor cores), "
              f"{fa.tiles(d, torch.float32)} float32 (CUDA cores)")
    sass_counts("flash_attention", "flash_tc_kernel",
                {"HMMA": ("HMMA",), "LDGSTS/UTMALDG": ("LDGSTS", "UTMALDG")},
                "K5")

    q, k, v = bf16
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    if not torch.allclose(lib.float(), fa.flash_attention_plain(
            q, k, v).float(), rtol=2e-2, atol=2e-2):
        fail("scaled_dot_product_attention disagrees with K5's plain "
             "version: the yardstick computes another function")
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v),
                       reps=20)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    f32 = [t.float() for t in bf16]
    f32_ms = time_ms(torch, lambda: fa.flash_attention(*f32), reps=50)
    print(f"kernel flash_attention float32 {SERVE_ATTN}: {f32_ms:.6f} "
          f"ms/launch (the CUDA-core kernel)", flush=True)
    del f32
    n_bytes = 2 * (2 * B * H * S * hd + 2 * B * K * S * hd)
    # QK^T and PV, 2 * hd operations each, over the S (S + 1) / 2 pairs a
    # causal mask keeps.
    n_ops = 2 * B * H * hd * S * (S + 1)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / BF16_OPS_PER_S * 1e3
    print(f"kernel flash_attention bf16 {SERVE_ATTN}: {ms:.6f} ms/launch, "
          f"plain {plain_ms:.6f} ms, scaled_dot_product_attention "
          f"{library_ms:.6f} ms, bytes {n_bytes}, ops {n_ops}, bound "
          f"{max(bytes_ms, ops_ms):.6f} ms", flush=True)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "bytes": n_bytes,
        "entry": "flash_attention", "equal": False}


def sass_counts(lib: str, kernel: str, ops: dict, label: str) -> None:
    """Count, per kernel in ``cuobjdump -sass`` of the built library of
    ``csrc/<lib>.cu``, the instructions of each entry of ``ops`` (name ->
    the SASS words it counts; the first entry the one its products run
    on); fail if a kernel whose name holds ``kernel`` has none of the
    first."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "-sass", str(_build.library_path(lib))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op, words in ops.items():
                counts[fn][op] += any(w in line for w in words)
    for fn, c in counts.items():
        print(f"sass {fn}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    tensor_op = next(iter(ops))
    tc = {fn: c for fn, c in counts.items() if kernel in fn}
    if not tc or not all(c[tensor_op] > 0 for c in tc.values()):
        fail(f"{label}: the kernels lack the instructions their products "
             f"run on ({tensor_op}): {tc}")


def cancelling_inputs(torch, np, dev, BH, S, hd, seed):
    """K6 inputs whose denominators nearly cancel: q.k of alternating sign
    (consecutive kv rows carry opposite keys of one random length along one
    direction every query shares), slow forget gates and input gates near
    3, so each row's sum of S[t, s] is a small alternating sum of its
    terms, above exp(-m) in most rows; float32, as the model hands K6 its
    operands."""
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
    return [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (q, k, v, F, i)]


def mlstm_phase(torch, np, dev) -> dict:
    """K6 against its plain version on the card, at the xlstm-350m prefill
    shape in float32 and with bf16 inputs, on small cases at the edges of
    its tiles and on near-cancelling denominators against a float64 plain
    version; times at the prefill shape."""
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import ops

    def model_layout(B, H, S, hd, dtype, seed):
        """q/k/v [B,S,H,hd] split out of one [B,S,3*H*hd] product and v
        pre-scaled, F (cumulative log-forget) and i [B,S,H] split out of
        one [B,S,2H] product, as the prefill makes them."""
        rng = np.random.default_rng(seed)
        qkv = torch.tensor(rng.standard_normal((B, S, 3 * H * hd)),
                           dtype=torch.float32, device=dev).to(dtype)
        q, k, v = (t.reshape(B, S, H, hd) for t in qkv.chunk(3, dim=-1))
        gates = torch.tensor(rng.standard_normal((B, S, 2 * H)),
                             dtype=torch.float32, device=dev)
        i, f = gates.chunk(2, dim=-1)
        F = torch.cumsum(torch.nn.functional.logsigmoid(f + 3.0), dim=1)
        return q, k, v / hd ** 0.5, F, i

    def plain(q, k, v, F, i):
        return ml.mlstm_parallel_plain(
            *(t.transpose(1, 2) for t in (q, k, v, F, i))).transpose(1, 2)

    def check(label, args, tol):
        got, want = ops.mlstm(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.isfinite(got).all() or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"K6 {label}: max abs err {err} against its plain version "
                 f"exceeds {tol}")
        print(f"kernel mlstm {label}: within {tol} of plain, max abs err "
              f"{err}", flush=True)
        return err

    B, H, S, hd = XLSTM_MLSTM
    f32 = model_layout(B, H, S, hd, torch.float32, seed=1)
    err = check(f"prefill shape {XLSTM_MLSTM} float32", f32, 2e-4)
    check(f"prefill shape {XLSTM_MLSTM} bf16",
          model_layout(B, H, S, hd, torch.bfloat16, seed=1), 3e-2)
    cases = [("hd 64", (2, 4, 256, 64)), ("hd 128", (1, 4, 320, 128)),
             ("hd 256", (2, 2, 256, 256)), ("ragged S 300", (2, 4, 300, 512)),
             ("S 20 below one tile", (2, 4, 20, 512)),
             ("BH 1", (1, 1, 1024, 512)), ("BH 16 S 320", (4, 4, 320, 512))]
    # S at the edges of the 64-row query tiles, 16-row warp groups, 32-row
    # kv tiles and 8-row v stages; then every head dim at a ragged S.
    cases += [(f"S {n} hd 512", (1, 2, n, 512))
              for n in (1, 15, 16, 17, 63, 64, 65, 1000)]
    cases += [(f"hd {d} S 300", (2, 2, 300, d)) for d in ml.HEAD_DIMS]
    for label, (b, h, s, d) in cases:
        check(label, model_layout(b, h, s, d, torch.float32, seed=s + d),
              2e-4)
    check("ragged S 300 bf16",
          model_layout(2, 4, 300, 512, torch.bfloat16, seed=3), 3e-2)
    # Rows one element off their allocation go in as aligned copies.
    q, k, v, F, i = model_layout(2, 2, 150, 512, torch.float32, seed=4)
    wide = torch.zeros(2, 150, 2, 513, device=dev)
    wide[..., 1:] = q
    check("q one element off its allocation", (wide[..., 1:], k, v, F, i),
          2e-4)

    for seed, (BH, n, d) in enumerate(((2, 1024, 512), (16, 1024, 512))):
        args = cancelling_inputs(torch, np, dev, BH, n, d, seed)
        exact = ml.mlstm_parallel_plain(*args, dtype=torch.float64)
        got = ml.mlstm_parallel(*args)
        plain32 = ml.mlstm_parallel_plain(*args)
        torch.cuda.synchronize()
        scores = torch.einsum("...td,...sd->...ts", args[0].double(),
                              args[1].double())
        D = args[3].double()[..., :, None] - args[3].double()[..., None, :] \
            + args[4].double()[..., None, :]
        D = D.masked_fill(~torch.ones(n, n, dtype=torch.bool, device=dev)
                          .tril(), float("-inf"))
        m = D.amax(-1, keepdim=True)
        scores = scores * torch.exp(D - m)
        ratio = float((scores.sum(-1).abs() / scores.abs().sum(-1))
                      .median())
        live = float((scores.sum(-1, keepdim=True).abs() > torch.exp(-m))
                     .double().mean())
        del scores, D
        d_kernel = float((got.double() - exact).abs().max())
        d_plain = float((plain32.double() - exact).abs().max())
        if not torch.isfinite(got).all() or not torch.allclose(
                got.double(), exact, rtol=2e-4, atol=2e-4):
            fail(f"K6 near-cancelling ({BH}, {n}, {d}): max abs distance "
                 f"{d_kernel} to the float64 plain version exceeds 2e-4")
        print(f"kernel mlstm near-cancelling denominator ({BH}, {n}, {d}) "
              f"(median |sum S| / sum |S| {ratio}, |sum S| > exp(-m) in "
              f"{live} of the rows): max abs distance to the float64 plain "
              f"version: kernel {d_kernel} (within 2e-4), float32 plain "
              f"{d_plain}", flush=True)
    # The products run as fp32 FMAs on the CUDA cores (the 3xTF32 tensor-
    # core design missed the model's per-block gates; PERF.md §6): FFMA is
    # required, HMMA printed (0).
    sass_counts("mlstm", "mlstm_kernel",
                {"FFMA": ("FFMA",), "LDGSTS": ("LDGSTS",),
                 "HMMA": ("HMMA",)}, "K6")

    ms = time_ms(torch, lambda: ops.mlstm(*f32), reps=50)
    plain_ms = time_ms(torch, lambda: plain(*f32), reps=20)
    # q, k, v, F, i read once, y written once (float32).
    n_bytes = 4 * (4 * B * S * H * hd + 2 * B * S * H)
    # q.k and S v, 2 * hd operations each, over the S (S + 1) / 2 causal
    # pairs, as fp32 FMAs on the CUDA cores (the route the kernel takes);
    # the bound of the same work as 3xTF32 on the tensor cores, three TF32
    # products each, is printed beside it.
    n_ops = 2 * hd * B * H * S * (S + 1)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    tf32_ms = 3 * n_ops / TF32_TC_OPS_PER_S * 1e3
    print(f"kernel mlstm float32 {XLSTM_MLSTM}: {ms:.6f} ms/launch, plain "
          f"{plain_ms:.6f} ms, bytes {n_bytes}, ops {n_ops}, bound "
          f"{max(bytes_ms, ops_ms):.6f} ms (fp32 on the CUDA cores; as "
          f"3xTF32 on the tensor cores {tf32_ms:.6f} ms)", flush=True)
    return {
        "name": "mlstm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm.py:31",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "bytes": n_bytes, "entry": "mlstm_parallel",
        "equal": False}


def launch_floor(torch, dev) -> float:
    """The per-launch floor of this card and stack: one in-place add on a
    one-element tensor, timed with ``time_ms`` as the kernels are."""
    x = torch.zeros(1, device=dev)
    ms = time_ms(torch, lambda: x.add_(1.0), reps=1000)
    print(f"launch floor: one in-place add on a one-element tensor "
          f"{ms:.6f} ms/launch (time_ms, 1000 back-to-back launches)",
          flush=True)
    return ms


def rmsnorm_swiglu_phase(torch, np, dev) -> list[dict]:
    """K7 and K8 against their plain versions on the card, in float32 and
    bf16 at the reference tests' shapes, ragged and decode shapes; times
    at the llama3.2-1b bf16 prefill shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import swiglu as sg

    def randn(rng, shape, dtype, scale=1.0, shift=0.0):
        a = rng.standard_normal(shape) * scale + shift
        return torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)

    def check(label, got, want, tol):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if got.shape != want.shape or got.dtype != want.dtype or \
                not torch.isfinite(got).all() or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"{label}: max abs err {err} against its plain version "
                 f"exceeds {tol}")
        print(f"kernel {label}: within {tol} of plain, max abs err {err}",
              flush=True)
        return err

    def norm_case(label, x, s, tol):
        check(f"rmsnorm {label}", rn.rmsnorm(x, s), rn.rmsnorm_plain(x, s),
              tol)

    def gate_case(label, x, wg, wu, tol):
        check(f"swiglu {label}", sg.swiglu(x, wg, wu),
              sg.swiglu_plain(x, wg, wu), tol)

    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        name = str(dtype).rsplit(".", 1)[-1]
        for rows, d in ((8, 128), (256, 512), (1024, 4096), (64, 3584),
                        (100, 3000), (37, 1001), (4, 2048), (16, 16384),
                        (4, 40000), (3, 9001)):
            rng = np.random.default_rng(rows + d)
            norm_case(f"({rows}, {d}) {name}", randn(rng, (rows, d), dtype),
                      randn(rng, (d,), dtype, shift=1.0), tol)
        wide = randn(np.random.default_rng(7), (64, 520), dtype)
        norm_case(f"(64, 512) view of row stride 520 {name}", wide[:, 4:516],
                  randn(np.random.default_rng(8), (512,), dtype, shift=1.0),
                  tol)
        # (M, K, N): one wgmma tile first (64, 16, 64), (64, 64, 64), then
        # the reference tests' shapes, K not a multiple of 64, ragged M and
        # N tiles and the decode shape.
        for M, K, N in ((64, 16, 64), (64, 64, 64), (128, 512, 128),
                        (256, 1024, 512), (128, 256, 384), (128, 300, 256),
                        (128, 2047, 128), (100, 300, 200), (129, 512, 136),
                        (4, 2048, 8192)):
            rng = np.random.default_rng(M + K + N)
            gate_case(f"({M}, {K}, {N}) {name}",
                      randn(rng, (M, K), dtype, 0.1),
                      randn(rng, (K, N), dtype, 0.05),
                      randn(rng, (K, N), dtype, 0.05), tol)
        rng = np.random.default_rng(9)
        x = randn(rng, (96, 256), dtype, 0.1)
        wg, wu = randn(rng, (256, 200), dtype, 0.05), \
            randn(rng, (256, 200), dtype, 0.05)
        gate_case(f"(96, 256, 136) column-slice weights {name}", x,
                  wg[:, 32:168], wu[:, 64:], tol)
        # x one element off its allocation and slices at odd offsets: the
        # bf16 wrapper hands TMA aligned copies.
        gate_case(f"(96, 256, 136) misaligned views {name}",
                  randn(rng, (96, 257), dtype, 0.1)[:, 1:], wg[:, 3:139],
                  wu[:, 61:197], tol)
        # |gate| up to ~180 from small integers (and u in 1/64ths): every
        # sum is exact in fp32 in any order, so the case measures silu at
        # extreme g and not sum order amplified by |g|.
        gate_case(f"(64, 256, 128) |gate| ~ 100 {name}",
                  *(torch.tensor(a, dtype=dtype, device=dev) for a in (
                      rng.integers(-2, 3, (64, 256)),
                      rng.integers(-3, 4, (256, 128)),
                      rng.integers(-3, 4, (256, 128)) / 64)), tol)

    rows, d, ff = SERVE_MLP
    bf16 = torch.bfloat16
    rng = np.random.default_rng(5)
    x, s = randn(rng, (rows, d), bf16), randn(rng, (d,), bf16, shift=1.0)
    err7 = check(f"rmsnorm serving shape ({rows}, {d}) bf16",
                 rn.rmsnorm(x, s), rn.rmsnorm_plain(x, s), 2e-2)
    if not torch.allclose(F.rms_norm(x, (d,), weight=s, eps=1e-6).float(),
                          rn.rmsnorm_plain(x, s).float(), rtol=2e-2,
                          atol=2e-2):
        fail("F.rms_norm disagrees with K7's plain version: the yardstick "
             "computes another function")
    ms7 = time_ms(torch, lambda: rn.rmsnorm(x, s))
    plain7 = time_ms(torch, lambda: rn.rmsnorm_plain(x, s))
    lib7 = time_ms(torch, lambda: F.rms_norm(x, (d,), weight=s, eps=1e-6))
    # x read and y written once (bf16), scale read once (bf16); a square,
    # an add, two multiplies per element.
    bytes7 = 2 * (2 * rows * d + d)
    ops7 = 4 * rows * d
    b7_ms, o7_ms = bytes7 / HBM_BYTES_PER_S * 1e3, ops7 / FP32_OPS_PER_S * 1e3
    print(f"kernel rmsnorm bf16 ({rows}, {d}): {ms7:.6f} ms/launch, plain "
          f"{plain7:.6f} ms, F.rms_norm {lib7:.6f} ms, bytes {bytes7}, ops "
          f"{ops7}, bound {max(b7_ms, o7_ms):.6f} ms", flush=True)

    xm = randn(rng, (rows, d), bf16)
    wg, wu = (randn(rng, (d, ff), bf16, d ** -0.5) for _ in range(2))
    err8 = check(f"swiglu serving shape ({rows}, {d}, {ff}) bf16",
                 sg.swiglu(xm, wg, wu), sg.swiglu_plain(xm, wg, wu), 2e-2)
    ms8 = time_ms(torch, lambda: sg.swiglu(xm, wg, wu), reps=10)
    plain8 = time_ms(torch, lambda: sg.swiglu_plain(xm, wg, wu), reps=10)
    composite = time_ms(torch, lambda: F.silu(xm @ wg) * (xm @ wu), reps=50)
    sass_counts("swiglu", "swiglu_tc_kernel",
                {"HGMMA": ("HGMMA",), "UTMALDG": ("UTMALDG",)}, "K8")
    x32, wg32, wu32 = xm[:1024].float(), wg.float(), wu.float()
    f32_ms = time_ms(torch, lambda: sg.swiglu(x32, wg32, wu32), reps=10)
    print(f"kernel swiglu float32 ({len(x32)}, {d}, {ff}): {f32_ms:.6f} "
          f"ms/launch (the CUDA-core kernel)", flush=True)
    del x32, wg32, wu32
    # x, w_gate, w_up read and out written once (bf16); two products.
    bytes8 = 2 * (rows * d + 2 * d * ff + rows * ff)
    ops8 = 4 * rows * d * ff
    b8_ms, o8_ms = bytes8 / HBM_BYTES_PER_S * 1e3, ops8 / BF16_OPS_PER_S * 1e3
    print(f"kernel swiglu bf16 ({rows}, {d}, {ff}): {ms8:.6f} ms/launch, "
          f"plain {plain8:.6f} ms, bytes {bytes8}, ops {ops8}, bound "
          f"{max(b8_ms, o8_ms):.6f} ms", flush=True)
    print(f"composite (not one PyTorch call, so not library_ms): "
          f"F.silu(x @ Wg) * (x @ Wu) in bf16 through cuBLAS, three calls, "
          f"{composite:.6f} ms at ({rows}, {d}, {ff})", flush=True)

    def row(name, replaces, err, ms, plain_ms, b_ms, o_ms, lib, n_bytes):
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": lib, "bytes": n_bytes, "entry": name,
            "equal": False}

    return [row("rmsnorm", "src/repro/kernels/rmsnorm.py:19", err7, ms7,
                plain7, b7_ms, o7_ms, lib7, bytes7),
            row("swiglu", "src/repro/kernels/swiglu.py:20", err8, ms8,
                plain8, b8_ms, o8_ms, None, bytes8)]


def device_busy(torch, fn) -> tuple[float, list]:
    """Device busy seconds of one call of ``fn`` under torch.profiler (CUDA
    activity only) and the busiest items."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    return sum(r[0] for r in rows) / 1e6, rows


def wall_s(torch, fn) -> float:
    """Host wall seconds of one call of ``fn``, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serving_phase(torch, np, kernels, totals: dict, dev) -> None:
    """llama3.2-1b at full width through prefill (K5 on) and the serve
    loop; the counters are zeroed just before and read just after."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    base = dataclasses.replace(get_config("llama3.2-1b"),
                               use_flash_kernel=True)
    L, V = base.n_layers, base.vocab
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    flash_prefills = 0

    # 1. float32 compute: K5 on against K5 off, and stepped decode.
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    on = build_model(cfg32, device=dev)
    off = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                      device=dev)
    t0 = time.perf_counter()
    params = on.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serving: llama3.2-1b full width, {n_params} float32 params "
          f"from torch.Generator seed 0 in {time.perf_counter() - t0:.3f} s",
          flush=True)
    toks = torch.tensor(rng.integers(0, V, (2, 512)), dtype=torch.int32,
                        device=dev)
    lg_on = on.prefill(params, {"tokens": toks})
    flash_prefills += 1
    lg_off = off.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    diff = float((lg_on - lg_off).abs().max())
    if not torch.isfinite(lg_on).all() or not torch.allclose(
            lg_on, lg_off, rtol=2e-4, atol=2e-4):
        fail(f"f32 prefill: K5 on vs off max abs diff {diff} exceeds 2e-4")
    cache = on.init_cache(2, 16)
    steps = []
    for pos in range(16):
        lg, cache = on.decode_step(params, cache, toks[:, pos],
                                   torch.full((2,), pos, dtype=torch.int32,
                                              device=dev))
        steps.append(lg)
    dec = torch.stack(steps, dim=1)
    dec_diff = float((dec - lg_on[:, :16]).abs().max())
    if not torch.allclose(dec, lg_on[:, :16], rtol=2e-2, atol=2e-2):
        fail(f"f32 decode: stepped logits vs K5 prefill max abs diff "
             f"{dec_diff} exceeds 2e-2")
    print(f"serving f32 B=2 S=512: prefill K5 on vs off max abs diff {diff} "
          f"(limit 2e-4); 16 decode steps vs K5 prefill max abs diff "
          f"{dec_diff} (limit 2e-2); logits |max| "
          f"{float(lg_on.abs().max())}", flush=True)
    del lg_on, lg_off, dec, steps, cache

    # 2. bf16 compute (the config's own): timed prefill, K5 on vs off.
    on = build_model(base, device=dev)
    off = build_model(dataclasses.replace(base, use_flash_kernel=False),
                      device=dev)
    batch = {"tokens": torch.tensor(rng.integers(0, V, (4, 1024)),
                                    dtype=torch.int32, device=dev)}
    on.prefill(params, batch)                               # warm-up
    flash_prefills += 1
    holder = {}
    t_on = wall_s(torch, lambda: holder.update(on=on.prefill(params, batch)))
    flash_prefills += 1
    t_off = wall_s(torch, lambda: holder.update(
        off=off.prefill(params, batch)))
    lg_on, lg_off = holder.pop("on"), holder.pop("off")
    if not all(bool(torch.isfinite(lg_on[b]).all()) for b in range(4)):
        fail("bf16 prefill: non-finite logits")
    diff = max(float((lg_on[b].float() - lg_off[b].float()).abs().max())
               for b in range(4))
    agree = sum(float((lg_on[b].argmax(-1) == lg_off[b].argmax(-1))
                      .float().sum()) for b in range(4)) / (4 * 1024)
    print(f"serving bf16 B=4 S=1024 prefill: K5 on {t_on:.6f} s, K5 off "
          f"{t_off:.6f} s; K5 on vs off max abs logit diff {diff}, argmax "
          f"agreement {agree}", flush=True)
    # The model's own bf16 rounding is the yardstick: the same tokens
    # through a float32 K5-off prefill.
    ref = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                      device=dev).prefill(params, batch)
    d_on, d_off = (max(float((lg[b].float() - ref[b]).abs().max())
                       for b in range(4)) for lg in (lg_on, lg_off))
    if not d_on <= 1.5 * d_off:
        fail(f"bf16 prefill: K5 on is {d_on} from the float32 prefill, more "
             f"than 1.5x K5 off's {d_off}")
    print(f"serving bf16 B=4 S=1024 prefill vs a float32 K5-off prefill of "
          f"the same tokens: max abs logit distance K5 on {d_on}, K5 off "
          f"{d_off} (limit: on <= 1.5x off)", flush=True)
    del lg_on, lg_off, ref
    busy, rows = device_busy(torch, lambda: on.prefill(params, batch))
    flash_prefills += 1
    print(f"device profile of one bf16 prefill: busy {busy:.6f} s of "
          f"{t_on:.6f} s wall, idle share {1.0 - busy / t_on:.6f}")
    for us, count, key in rows[:6]:
        print(f"  device {us / 1e3:.3f} ms in {count} x {key[:70]}")
    prompt = torch.tensor(rng.integers(0, V, (4, 16)), dtype=torch.int32,
                          device=dev)
    loop = lambda: serve.serve_loop(on, params, prompt, 8)     # noqa: E731
    t_loop = wall_s(torch, loop)
    busy, rows = device_busy(torch, loop)
    print(f"device profile of a serve loop (prompt 16, 8 tokens): busy "
          f"{busy:.6f} s of {t_loop:.6f} s wall, idle share "
          f"{1.0 - busy / t_loop:.6f}")
    for us, count, key in rows[:6]:
        print(f"  device {us / 1e3:.3f} ms in {count} x {key[:70]}")
    del params, on, off
    torch.cuda.empty_cache()

    # 3. The serve CLI at its defaults (batch 4, prompt 16, 32 tokens).
    res = serve.main(["--device", str(dev)])
    tokens, logits = res["tokens"], res["logits"]
    if not bool(torch.isfinite(logits).all()):
        fail("serve loop: non-finite logits")
    if tokens.shape != (4, 32) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= V:
        fail(f"serve loop: tokens {tuple(tokens.shape)} outside [0, {V})")
    print(f"serve loop llama3.2-1b full width bf16: prefill (15 stepped "
          f"positions) {res['prefill_s']:.6f} s, decode {res['decode_s']:.6f}"
          f" s, {4 * 32 / res['decode_s']:.3f} tok/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    counts = kernels.launch_counts()
    if counts["flash_attention"] != L * flash_prefills:
        fail(f"serving: K5 launched {counts['flash_attention']} times, "
             f"expected {L} per K5 prefill x {flash_prefills}")
    for name, n in counts.items():
        totals[name] += n
    print(f"serving launches {counts}", flush=True)


def split_seconds(torch, module, names, spent: dict | None = None) -> dict:
    """Wrap ``module``'s functions ``names`` in place so that each call
    adds its host wall seconds, ending in a synchronize, to the returned
    dict (``spent`` when given; the callers look the functions up on
    ``module`` at call time)."""
    spent = {} if spent is None else spent
    spent.update(dict.fromkeys(names, 0.0))
    for name in names:
        def timed(*args, _fn=getattr(module, name), _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                spent[_name] += time.perf_counter() - t0

        setattr(module, name, timed)
    return spent


def per_block_checks(torch, xlstm, model, params, toks) -> tuple:
    """One float32 prefill with K6 on, in which every block is also checked
    on its own inputs: each mLSTM block's K6 output against the same block
    with K6 off (the query-chunked form) within 2e-4, and the first 16
    positions of each block against 16 steps of its decode recurrence from
    the zero state within 2e-2.  Whole-prefill comparisons cannot hold
    such tolerances here: at random init the 24-layer stack amplifies a
    one-ulp change of its input to O(1) logits (printed by the caller).
    Returns the logits and the worst difference of each check."""
    import dataclasses

    from repro_torch.models import ssm

    cfg_off = dataclasses.replace(model.config, use_flash_kernel=False)
    worst = {"k6": 0.0, "decode": 0.0}
    blocks = {"mlstm_seq": xlstm.mlstm_seq, "slstm_seq": xlstm.slstm_seq}
    steps = {"mlstm_seq": (ssm.mlstm_step, ssm.init_mlstm_state),
             "slstm_seq": (ssm.slstm_step, ssm.init_slstm_state)}

    def checked(name):
        def run(cfg_, p, x):
            y = blocks[name](cfg_, p, x)
            if name == "mlstm_seq":
                y_off = blocks[name](cfg_off, p, x)
                diff = float((y - y_off).abs().max())
                worst["k6"] = max(worst["k6"], diff)
                if not torch.allclose(y, y_off, rtol=2e-4, atol=2e-4):
                    fail(f"xlstm f32 mLSTM block: K6 on vs off max abs diff "
                         f"{diff} exceeds 2e-4")
            step, init_state = steps[name]
            state, outs = init_state(cfg_, x.shape[0], x.device), []
            for t in range(16):
                o, state = step(cfg_, p, state, x[:, t])
                outs.append(o)
            dec = torch.stack(outs, dim=1)
            diff = float((dec - y[:, :16]).abs().max())
            worst["decode"] = max(worst["decode"], diff)
            if not torch.allclose(dec, y[:, :16], rtol=2e-2, atol=2e-2):
                fail(f"xlstm f32 {name[:5]} block: 16 stepped positions vs "
                     f"the parallel form max abs diff {diff} exceeds 2e-2")
            return y
        return run

    for name in blocks:
        setattr(xlstm, name, checked(name))
    try:
        logits = model.prefill(params, {"tokens": toks})
    finally:
        for name, fn in blocks.items():
            setattr(xlstm, name, fn)
    torch.cuda.synchronize()
    return logits, worst


def xlstm_phase(torch, np, kernels, totals: dict, dev) -> None:
    """xlstm-350m at full width through prefill (K6 on) and the serve loop;
    the counters are zeroed just before and read just after."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model, xlstm

    base = dataclasses.replace(get_config("xlstm-350m"),
                               use_flash_kernel=True)
    n_mlstm = base.n_layers // base.slstm_every * (base.slstm_every - 1)
    V = base.vocab
    rng = np.random.default_rng(2)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    k6_prefills = 0

    # (a) float32 compute: K6 against K6 off and stepped decode against
    # the parallel form, block by block on the same inputs (see
    # per_block_checks), and the whole prefill's sensitivity.
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    on = build_model(cfg32, device=dev)
    off = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                      device=dev)
    t0 = time.perf_counter()
    params = on.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"xlstm: xlstm-350m full width, {n_params} float32 params from "
          f"torch.Generator seed 0 in {time.perf_counter() - t0:.3f} s",
          flush=True)
    toks = torch.tensor(rng.integers(0, V, (2, 1024)), dtype=torch.int32,
                        device=dev)
    lg_on, worst = per_block_checks(torch, xlstm, on, params, toks)
    k6_prefills += 1
    print(f"xlstm f32 B=2 S=1024, each of the {n_mlstm} mLSTM and "
          f"{base.n_layers - n_mlstm} sLSTM blocks on the K6 prefill's own "
          f"inputs: K6 on vs off max abs diff {worst['k6']} (within rtol = "
          f"atol = 2e-4); 16 stepped decode positions vs the parallel form "
          f"max abs diff {worst['decode']} (within rtol = atol = 2e-2)",
          flush=True)
    lg_off = off.prefill(params, {"tokens": toks})
    nudged = dict(params, embed=torch.nextafter(
        params["embed"], torch.full_like(params["embed"], float("inf"))))
    lg_nudged = off.prefill(nudged, {"tokens": toks})
    torch.cuda.synchronize()
    if not torch.isfinite(lg_on).all() or lg_on.shape != (2, 1024, V):
        fail(f"xlstm f32 prefill: logits {tuple(lg_on.shape)} not finite")
    print(f"xlstm f32 whole prefill (reported, not gated): K6 on vs off max "
          f"abs logit diff {float((lg_on - lg_off).abs().max())}; K6 off vs "
          f"K6 off with the embeddings one ulp up "
          f"{float((lg_nudged - lg_off).abs().max())}; logits |max| "
          f"{float(lg_off.abs().max())}", flush=True)
    del lg_on, lg_off, lg_nudged, nudged

    # (b) bf16 compute (the config's own): timed prefill, K6 on vs off.
    on = build_model(base, device=dev)
    off = build_model(dataclasses.replace(base, use_flash_kernel=False),
                      device=dev)
    batch = {"tokens": torch.tensor(rng.integers(0, V, (4, 1024)),
                                    dtype=torch.int32, device=dev)}
    on.prefill(params, batch)                               # warm-up
    k6_prefills += 1
    holder = {}
    t_on = wall_s(torch, lambda: holder.update(on=on.prefill(params, batch)))
    k6_prefills += 1
    t_off = wall_s(torch, lambda: holder.update(
        off=off.prefill(params, batch)))
    lg_on, lg_off = holder.pop("on"), holder.pop("off")
    if not bool(torch.isfinite(lg_on).all()):
        fail("xlstm bf16 prefill: non-finite logits")
    diff = float((lg_on.float() - lg_off.float()).abs().max())
    agree = float((lg_on.argmax(-1) == lg_off.argmax(-1)).float().mean())
    print(f"xlstm bf16 B=4 S=1024 prefill: K6 on {t_on:.6f} s, K6 off "
          f"{t_off:.6f} s; K6 on vs off max abs logit diff {diff}, argmax "
          f"agreement {agree}", flush=True)
    del lg_on, lg_off
    blocks = {name: getattr(xlstm, name) for name in ("mlstm_seq",
                                                      "slstm_seq")}
    spent = split_seconds(torch, xlstm, blocks)
    try:
        t_split = wall_s(torch, lambda: on.prefill(params, batch))
    finally:
        for name, fn in blocks.items():
            setattr(xlstm, name, fn)
    k6_prefills += 1
    print(f"xlstm bf16 prefill split (each block synchronised): mLSTM "
          f"blocks {spent['mlstm_seq']:.6f} s, sLSTM blocks (Python loop "
          f"over S) {spent['slstm_seq']:.6f} s, of {t_split:.6f} s",
          flush=True)
    busy, rows = device_busy(torch, lambda: on.prefill(params, batch))
    k6_prefills += 1
    k6 = [(us, count) for us, count, key in rows if "mlstm_kernel" in key]
    print(f"device profile of one xlstm bf16 prefill: busy {busy:.6f} s of "
          f"{t_on:.6f} s wall, idle share {1.0 - busy / t_on:.6f}; K6 "
          f"{sum(us for us, _ in k6) / 1e3:.3f} ms in "
          f"{sum(c for _, c in k6)} launches")
    for us, count, key in rows[:6]:
        print(f"  device {us / 1e3:.3f} ms in {count} x {key[:70]}")
    del params, on, off
    torch.cuda.empty_cache()

    # (c) The serve CLI at its defaults (batch 4, prompt 16, 32 tokens).
    res = serve.main(["--arch", "xlstm-350m", "--device", str(dev)])
    tokens, logits = res["tokens"], res["logits"]
    if not bool(torch.isfinite(logits).all()):
        fail("xlstm serve loop: non-finite logits")
    if tokens.shape != (4, 32) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= V:
        fail(f"xlstm serve loop: tokens {tuple(tokens.shape)} outside "
             f"[0, {V})")
    print(f"serve loop xlstm-350m full width bf16: prefill (15 stepped "
          f"positions) {res['prefill_s']:.6f} s, decode {res['decode_s']:.6f}"
          f" s, {4 * 32 / res['decode_s']:.3f} tok/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    counts = kernels.launch_counts()
    if counts["mlstm"] != n_mlstm * k6_prefills:
        fail(f"xlstm: K6 launched {counts['mlstm']} times, expected "
             f"{n_mlstm} per K6 prefill x {k6_prefills}")
    for name, n in counts.items():
        totals[name] += n
    print(f"xlstm launches {counts}", flush=True)


def entry_point_phase(torch, np, kernels, totals: dict, dev) -> None:
    """``ops.rmsnorm`` and ``ops.swiglu`` on llama3.2-1b's own activations
    at full width: each norm and MLP input of a float32 and a bf16 prefill
    also goes through the entry point and is held against the kernel's
    plain version; the model's own results flow on.  The counters are
    zeroed just before and read just after."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import swiglu as sg
    from repro_torch.models import build_model, transformer

    base = dataclasses.replace(get_config("llama3.2-1b"),
                               use_flash_kernel=True)
    L, V = base.n_layers, base.vocab
    rng = np.random.default_rng(3)
    norm, mlp = transformer.rms_norm, transformer.mlp
    worst: dict = {}

    def note(key, got, want):
        worst[key] = max(worst.get(key, 0.0),
                         float((got.float() - want.float()).abs().max()))

    def held(label, got, want, tol):
        note(label, got, want)
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"entry points: {label} max abs err {worst[label]} against "
                 f"its plain version exceeds {tol}")

    def checked_norm(x, scale, eps, cast_early=False):
        y = norm(x, scale, eps, cast_early)
        tol = 2e-2 if x.dtype == torch.bfloat16 else 2e-5
        got = ops.rmsnorm(x, scale, eps)
        held("ops.rmsnorm", got, rn.rmsnorm_plain(x, scale, eps), tol)
        note("ops.rmsnorm vs model rms_norm", got, y)
        return y

    def checked_mlp(p, x, kind):
        y = mlp(p, x, kind)
        cd = x.dtype
        tol = 2e-2 if cd == torch.bfloat16 else 2e-5
        wg, wu = p["w_gate"].to(cd), p["w_up"].to(cd)
        got = ops.swiglu(x, wg, wu)
        held("ops.swiglu", got, sg.swiglu_plain(x, wg, wu), tol)
        note("ops.swiglu vs model gate", got, F.silu(x @ wg) * (x @ wu))
        return y

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = None
    for dtype, B, S in (("float32", 2, 512), ("bfloat16", 4, 1024)):
        model = build_model(dataclasses.replace(base, compute_dtype=dtype),
                            device=dev)
        if params is None:
            params = model.init(0)
        batch = {"tokens": torch.tensor(rng.integers(0, V, (B, S)),
                                        dtype=torch.int32, device=dev)}
        want = model.prefill(params, batch)
        before = kernels.launch_counts()
        worst.clear()
        holder = {}
        transformer.rms_norm, transformer.mlp = checked_norm, checked_mlp
        try:
            t = wall_s(torch, lambda: holder.update(
                got=model.prefill(params, batch)))
        finally:
            transformer.rms_norm, transformer.mlp = norm, mlp
        got = holder.pop("got")
        n7 = kernels.LAUNCHES["rmsnorm"] - before["rmsnorm"]
        n8 = kernels.LAUNCHES["swiglu"] - before["swiglu"]
        if (n7, n8) != (2 * L + 1, L):
            fail(f"entry points {dtype}: K7 launched {n7} times and K8 {n8} "
                 f"in one prefill, expected {2 * L + 1} and {L}")
        if not torch.equal(got, want):
            fail(f"entry points {dtype}: the checked prefill's logits differ "
                 "from an unpatched prefill's")
        if not bool(torch.isfinite(got).all()):
            fail(f"entry points {dtype}: non-finite logits")
        profiled = ""
        if dtype == "bfloat16":
            transformer.rms_norm, transformer.mlp = checked_norm, checked_mlp
            try:
                busy, items = device_busy(
                    torch, lambda: model.prefill(params, batch))
            finally:
                transformer.rms_norm, transformer.mlp = norm, mlp
            k8_s = sum(us for us, _, key in items
                       if "swiglu_tc_kernel" in key) / 1e6
            profiled = (f"; one more checked prefill under torch.profiler: "
                        f"device busy {busy:.6f} s, of it K8 {k8_s:.6f} s")
        print(f"entry points llama3.2-1b {dtype} B={B} S={S} prefill, "
              f"{n7} ops.rmsnorm and {n8} ops.swiglu calls on its own "
              f"activations: max abs err vs plain "
              f"{worst['ops.rmsnorm']} (K7), {worst['ops.swiglu']} (K8); "
              f"reported, not gated: vs the model's in-line rms_norm "
              f"{worst['ops.rmsnorm vs model rms_norm']}, vs its in-line "
              f"gate math {worst['ops.swiglu vs model gate']}; logits "
              f"torch.equal to an unpatched prefill; checked prefill "
              f"{t:.6f} s{profiled}", flush=True)
        del want, got, model
    del params
    torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    for name, n in counts.items():
        totals[name] += n
    print(f"entry-point phase {time.perf_counter() - t_phase:.6f} s wall "
          f"(params init included); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{counts}", flush=True)


SERVICE_POLICIES = ("sjf-bco", "sjf-bco-dynamic", "gadget-elastic", "wang-ca")
SERVICE_HORIZON = 10**6        # an open-ended stream: the budget is the horizon


def same_drain(np, a, b) -> bool:
    """Two (schedule, sim) pairs bit for bit: the schedule's fields and
    quotas, every job's start and finish, makespan, avg JCT, the events."""
    (sa, ma), (sb, mb) = a, b
    return (same_schedule(sa, sb)
            and (sa.quotas is None) == (sb.quotas is None)
            and (sa.quotas is None or bool(np.array_equal(sa.quotas,
                                                          sb.quotas)))
            and bool(np.array_equal(ma.start, mb.start))
            and bool(np.array_equal(ma.finish, mb.finish))
            and (ma.makespan, ma.avg_jct, ma.completed)
            == (mb.makespan, mb.avg_jct, mb.completed)
            and ma.events == mb.events)


def service_drain(torch, svc_mod, cluster, jobs, arrivals, policy, device,
                  **kw):
    """Submit the whole stream to a fresh service and drain it; returns
    (service, (schedule, sim), wall seconds)."""
    svc = svc_mod.SchedulerService(cluster, policy=policy, device=device,
                                   horizon=SERVICE_HORIZON, **kw)
    t0 = time.perf_counter()
    for job, arrival in zip(jobs, arrivals):
        svc.submit(svc_mod.SubmitRequest(job, int(arrival)))
    out = svc.drain()
    if device == "cuda":
        torch.cuda.synchronize()
    return svc, out, time.perf_counter() - t0


def decision_stats(np, svc, schedule) -> str:
    lat = np.asarray(svc.daemon.decision_latencies)
    placed = len(schedule.assignment)
    return (f"{placed} placed in {len(lat)} decisions, "
            f"{placed / lat.sum():.1f} decisions/s, decision ms p50 "
            f"{np.percentile(lat, 50) * 1e3:.6f} p99 "
            f"{np.percentile(lat, 99) * 1e3:.6f} max "
            f"{lat.max() * 1e3:.6f}")


def service_trace(np, rt, n_jobs: int, traffic: str, seed: int = 1):
    """The service benchmark's submission trace: |J| Philly-mix jobs on
    max(20, |J| // 16) servers; Poisson gaps of mean 2 slots, or waves of
    32 simultaneous submissions every 64 slots."""
    cluster = rt.philly_cluster(max(20, n_jobs // 16), seed=seed)
    jobs = rt.philly_workload(seed=seed, mix=mix_for(n_jobs))
    rng = np.random.default_rng(seed)
    if traffic == "poisson":
        arrivals = np.floor(np.cumsum(
            rng.exponential(2.0, size=len(jobs)))).astype(np.int64)
    else:
        wave = np.repeat(np.arange((len(jobs) + 31) // 32), 32)[:len(jobs)]
        arrivals = (wave * 64).astype(np.int64)
    return cluster, jobs, arrivals


def cut_journal(svc_mod, entries, paths) -> None:
    """Write the first half of a journal into fresh sqlite stores: the
    journal a daemon killed mid-stream leaves behind."""
    for path in paths:
        store = svc_mod.SqliteStore(path)
        for e in entries[:len(entries) // 2]:
            store.append(e.kind, e.jid, e.payload, ts=e.ts)
        store.close()


def recover_and_finish(torch, np, svc_mod, workdir, tag, entries, policy,
                       jobs, arrivals, want, label) -> None:
    """Recover a cut journal on the card and on the CPU, hold the card's
    clocks at the cut against the CPU's (the uncut daemon's clocks at that
    entry: replay is exact), then resubmit the rest of the stream on the
    card and hold its drain against the uncut one."""
    card_path = str(workdir / f"{tag}_cut.db")
    cpu_path = str(workdir / f"{tag}_cut_cpu.db")
    cut_journal(svc_mod, entries, (card_path, cpu_path))
    t0 = time.perf_counter()
    rec = svc_mod.SchedulerService.recover(None, card_path, policy=policy,
                                           device="cuda",
                                           horizon=SERVICE_HORIZON)
    t_rec = time.perf_counter() - t0
    host = svc_mod.SchedulerService.recover(None, cpu_path, policy=policy,
                                            device="cpu",
                                            horizon=SERVICE_HORIZON)
    a, b = rec.daemon.state, host.daemon.state
    if not (np.array_equal(a.U, b.U) and np.array_equal(a.R, b.R)
            and a.est_finish == b.est_finish):
        fail(f"{label}: the card's recovered clocks differ from the CPU's")
    n_cut = len(rec.daemon.jobs)
    for job, arrival in list(zip(jobs, arrivals))[n_cut:]:
        rec.submit(svc_mod.SubmitRequest(job, int(arrival)))
    got = rec.drain()
    torch.cuda.synchronize()
    if not same_drain(np, want, got):
        fail(f"{label}: the recovered drain differs from the uncut one")
    print(f"{label}: cut at entry {len(entries) // 2} of {len(entries)} "
          f"({n_cut} jobs journaled), recovered on the card in "
          f"{t_rec:.6f} s with U/R bitwise equal to the CPU's; the rest "
          f"resubmitted and drained bitwise equal to the uncut drain",
          flush=True)
    rec.close()
    host.close()


def service_phase(torch, np, rt, kernels, totals: dict) -> None:
    """Phase 9: the scheduler service on the card, every drain held
    bitwise against the port's CPU service with the reference defaults."""
    import tempfile

    import repro_torch.service as svc_mod
    from repro_torch import obs
    from repro_torch.core.online import (poisson_arrivals, run_online,
                                         stream_request)
    from repro_torch.core.theory import report
    from repro_torch.core.trace import replay_trace

    t_phase = time.perf_counter()

    def counted(label, needs):
        counts = kernels.launch_counts()
        for name in needs:
            if counts[name] <= 0:
                fail(f"{label}: kernel {name} was never launched")
        for name, n in counts.items():
            totals[name] += n
        return counts

    # 1. The §7 online stream through the service, four policies.
    streams = {}
    for kind in ("hom", "het"):
        cluster = rt.philly_cluster(20, seed=1,
                                    **(HETERO if kind == "het" else {}))
        stream = poisson_arrivals(rt.philly_workload(seed=1), rate=0.5,
                                  seed=1)
        request = stream_request(cluster, stream, horizon=SERVICE_HORIZON)
        streams[kind] = (cluster, stream, request.jobs, request.arrivals)
        tau = "tau_het" if kind == "het" else "tau"
        for policy in SERVICE_POLICIES:
            label = f"service §7 {kind} {policy}"
            kernels.reset_launch_counts()
            card, got, t_card = service_drain(
                torch, svc_mod, cluster, request.jobs, request.arrivals,
                policy, "cuda")
            counts = counted(label, (tau,))
            host, want, t_host = service_drain(
                torch, svc_mod, cluster, request.jobs, request.arrivals,
                policy, "cpu")
            if not same_drain(np, got, want):
                fail(f"{label}: the card's drain differs from the CPU's")
            oneshot = rt.get_policy(policy)(request)
            if not same_schedule(oneshot, got[0]):
                fail(f"{label}: the drain differs from schedule_arrivals")
            kernels.reset_launch_counts()
            asg, sim = run_online(cluster, stream, policy=policy,
                                  device="cuda")
            torch.cuda.synchronize()
            online_counts = counted(f"{label} run_online", (tau,))
            if len(asg) != len(got[0].assignment) or not all(
                    j1 == j2 and bool((g1 == g2).all()) for (j1, g1), (j2, g2)
                    in zip(asg, got[0].assignment)) or \
                    not np.array_equal(sim.finish, got[1].finish):
                fail(f"{label}: run_online on the card differs from the "
                     "drain")
            evicts = sum(e.kind in ("evict", "resize")
                         for e in card.daemon.store.entries())
            decisions = len(card.daemon.decision_latencies)
            if kind == "hom" and policy == "sjf-bco-dynamic":
                streams["dynamic"] = (card.daemon.store.entries(), got)
            print(f"{label}: bitwise equal to the CPU drain, to "
                  f"schedule_arrivals and to run_online on the card; "
                  f"makespan {got[1].makespan} avg_jct {got[1].avg_jct}; "
                  f"{evicts} evict/resize records; card {t_card:.6f} s, "
                  f"cpu {t_host:.6f} s; {tau} {counts[tau]} launches "
                  f"({counts[tau] / decisions:.3f} a decision), run_online "
                  f"{online_counts[tau]}; "
                  f"{decision_stats(np, card, got[0])}", flush=True)

    # 2. The service benchmark's traffic at |J| = 1024, card beside CPU.
    drains = {}
    for traffic in ("poisson", "burst"):
        cluster, jobs, arrivals = service_trace(np, rt, 1024, traffic)
        label = (f"service |J|={len(jobs)} S={cluster.num_servers} "
                 f"{traffic} sjf-bco")
        kernels.reset_launch_counts()
        obs.start()
        card, got, t_card = service_drain(torch, svc_mod, cluster, jobs,
                                          arrivals, "sjf-bco", "cuda")
        in_kernels, in_calls = entry_points(obs.stop())
        counts = counted(label, ("tau",))
        host, want, t_host = service_drain(torch, svc_mod, cluster, jobs,
                                           arrivals, "sjf-bco", "cpu")
        if not same_drain(np, got, want):
            fail(f"{label}: the card's drain differs from the CPU's")
        drains[traffic] = (cluster, jobs, arrivals, got, t_card)
        decisions = len(card.daemon.decision_latencies)
        print(f"{label}: bitwise equal to the CPU drain; {card.daemon.rounds}"
              f" rounds; K1 {counts['tau']} launches "
              f"({counts['tau'] / decisions:.3f} a decision)", flush=True)
        print(f"  card: drain wall {t_card:.6f} s; "
              f"{decision_stats(np, card, got[0])}", flush=True)
        print(f"  cpu:  drain wall {t_host:.6f} s; "
              f"{decision_stats(np, host, want[0])}", flush=True)
        print_entry_points(in_kernels, in_calls, t_card)
    cluster, jobs, arrivals, _, wall = drains["poisson"]
    kernels.reset_launch_counts()
    device_profile(torch, f"the |J|={len(jobs)} poisson service drain",
                   lambda: service_drain(torch, svc_mod, cluster, jobs,
                                         arrivals, "sjf-bco", "cuda"), wall)
    counted("service profile", ("tau",))

    # 3. Journal durability and recovery on the card.
    workdir_root = ROOT / "build"
    workdir_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir_root) as td:
        workdir = Path(td)
        cluster, jobs, arrivals, uncut, t_mem = drains["poisson"]
        label = f"service |J|={len(jobs)} poisson sqlite"
        kernels.reset_launch_counts()
        card, got, t_sql = service_drain(
            torch, svc_mod, cluster, jobs, arrivals, "sjf-bco", "cuda",
            store_path=str(workdir / "journal.db"))
        counted(label, ("tau",))
        entries = card.daemon.store.entries()
        card.close()
        if not same_drain(np, got, uncut):
            fail(f"{label}: the sqlite-journaled drain differs from the "
                 "in-memory one")
        print(f"{label}: {len(entries)} entries, "
              f"{len(entries) / t_sql:.1f} appends/s; drain wall "
              f"{t_sql:.6f} s against {t_mem:.6f} s in memory", flush=True)
        kernels.reset_launch_counts()
        recover_and_finish(torch, np, svc_mod, workdir, "poisson", entries,
                           "sjf-bco", jobs, arrivals, uncut,
                           f"{label} recovery")
        counted(f"{label} recovery", ("tau",))
        cluster, stream, jobs, arrivals = streams["hom"]
        entries, uncut = streams["dynamic"]
        n_evict = sum(e.kind == "evict" for e in entries)
        if n_evict <= 0:
            fail("service §7 sjf-bco-dynamic: the journal holds no evict "
                 "record")
        label = f"service §7 hom sjf-bco-dynamic sqlite ({n_evict} evicts)"
        kernels.reset_launch_counts()
        recover_and_finish(torch, np, svc_mod, workdir, "dynamic", entries,
                           "sjf-bco-dynamic", jobs, arrivals, uncut,
                           f"{label} recovery")
        counted(f"{label} recovery", ("tau",))

    # 4. Batch preemption through run_scenario.
    expect = {("hom", "incremental"): ("pool",),
              ("hom", "batched"): ("pool", "tau"),
              ("het", "incremental"): ("pool", "score"),
              ("het", "batched"): ("pool", "tau_het")}
    for (kind, engine), needs in expect.items():
        spec = rt.Scenario(
            cluster=rt.ClusterSpec(num_servers=20, seed=1,
                                   **(HETERO if kind == "het" else {})),
            workload=rt.WorkloadSpec(seed=1), policy="sjf-bco-dynamic",
            policy_params=(("engine", engine),), horizon=1200)
        label = f"sjf-bco-dynamic batch §7 {kind} {engine}"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card = rt.run_scenario(spec, device="cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        counts = counted(label, needs)
        t0 = time.perf_counter()
        host = rt.run_scenario(spec, device="cpu")
        t_host = time.perf_counter() - t0
        if not same_drain(np, (card.schedule, card.sim),
                          (host.schedule, host.sim)):
            fail(f"{label}: the card's run differs from the CPU's")
        print(f"{label}: bitwise equal to the CPU run; policy "
              f"{card.schedule.policy} makespan {card.sim.makespan} avg_jct "
              f"{card.sim.avg_jct}; card {t_card:.6f} s, cpu {t_host:.6f} s; "
              f"K1 {counts['tau']} K2 {counts['tau_het']} K3 "
              f"{counts['pool']} K4 {counts['score']} launches", flush=True)

    # 5. The §6 certificate and trace replay.
    spec = rt.Scenario(cluster=rt.ClusterSpec(num_servers=20, seed=1),
                       workload=rt.WorkloadSpec(seed=1), policy="sjf-bco",
                       horizon=1200)
    kernels.reset_launch_counts()
    reports = {}
    for device in ("cuda", "cpu"):
        run = rt.run_scenario(spec, device=device)
        reports[device] = report(spec.cluster.build(), spec.workload.build(),
                                 run.schedule, run.sim)
    counted("theory §7 hom sjf-bco", ("pool",))
    cert = reports["cuda"]
    if cert != reports["cpu"] or not cert.certified:
        fail(f"theory: the card's certificate {cert} differs from the "
             f"CPU's {reports['cpu']} or is not certified")
    print(f"theory §7 hom sjf-bco: equal on both devices, certified "
          f"{cert.certified}: {cert}", flush=True)
    cluster = rt.ClusterSpec(num_servers=4, seed=2).build()
    outs = {}
    kernels.reset_launch_counts()
    for device in ("cuda", "cpu"):
        svc = svc_mod.SchedulerService(cluster, policy="sjf-bco",
                                       device=device)
        records = replay_trace(svc.daemon, str(ROOT / "examples" /
                                               "sample_trace.csv"))
        outs[device] = svc.drain()
    counts = counted("replay_trace", ("tau",))
    card_out, host_out = outs.values()
    if not same_drain(np, card_out, host_out):
        fail("replay_trace: the card daemon's drain differs from the CPU's")
    print(f"replay_trace examples/sample_trace.csv: {len(records)} jobs, "
          f"card drain bitwise equal to the CPU's, makespan "
          f"{card_out[1].makespan}; K1 {counts['tau']} launches", flush=True)
    print(f"service phase {time.perf_counter() - t_phase:.6f} s wall",
          flush=True)


# Phase 10 at llama3.2-1b's full width: ring width, global batch, seq, steps.
TRAIN = dict(w=4, batch=8, seq=256, steps=5)
# The ring-averaged gradient against the single-program gradient of the
# concatenated batch, relative L2 gap, bf16 compute: 3.2e-3 to 3.8e-3 on
# the CPU at reduced width (tests/test_torch_train.py holds 1e-2 there).
GRAD_GAP_TOL = 1e-2


def ring_phase(torch, rar, d: int, w: int, dev) -> None:
    """Phase 10a: the ring on a [w, d] float32 buffer on the card, bitwise
    against a plain loop of adds in the ring's order, within 2e-5 of
    ``torch.sum`` over the workers, its steps and bytes against §3."""
    if d % w:
        fail(f"ring: d = {d} is not a multiple of w = {w}")
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((w, d), generator=gen, device=dev)
    # The reference's schedule, written out: the partial of chunk c starts
    # at worker c - 1 and gains workers c - 2, c - 3, ... and c last.
    m = d // w
    plain = torch.empty(d, device=dev)
    for c in range(w):
        cols = slice(c * m, (c + 1) * m)
        acc = x[(c - 1) % w, cols].clone()
        for k in range(2, w + 1):
            acc += x[(c - k) % w, cols]
        plain[cols] = acc
    total = x.sum(dim=0)
    rar.reset_ring_counts()
    rar.ring_all_reduce(x, out=x)
    torch.cuda.synchronize()
    counts = rar.ring_counts()
    if not all(torch.equal(x[i], plain) for i in range(w)):
        fail("ring: a row differs from the plain ring-order loop")
    gap = float((x[0] - total).abs().max())
    if not gap <= 2e-5:
        fail(f"ring: max abs diff {gap} from torch.sum exceeds 2e-5")
    want = rar.exchange_bytes_per_worker(4 * d, w)
    if counts != {"steps": 2 * (w - 1), "bytes": want}:
        fail(f"ring: counted {counts}, expected {2 * (w - 1)} steps and "
             f"{want} bytes a worker")
    del plain, total
    ms = time_ms(torch, lambda: rar.ring_all_reduce(x, out=x), reps=5)
    print(f"ring w={w} d={d} float32 on the card: every row bitwise equal "
          f"to the plain ring-order loop; max abs diff from torch.sum {gap} "
          f"(limit 2e-5); {counts['steps']} steps, {counts['bytes']} bytes "
          f"sent a worker (= 2 d (w-1)/w); {ms:.6f} ms a ring, "
          f"{w * want / ms / 1e6:.3f} GB/s of ring traffic as on-card "
          f"copies (not link bandwidth)", flush=True)
    del x
    torch.cuda.empty_cache()


def timed_calls(torch, pairs):
    """Wrap each ``(module, name)`` with :func:`split_seconds`; returns the
    seconds dict and a function that puts the originals back."""
    spent, saved = {}, []
    for module, name in pairs:
        saved.append((module, name, getattr(module, name)))
        split_seconds(torch, module, [name], spent)

    def restore():
        for module, name, fn in saved:
            setattr(module, name, fn)

    return spent, restore


def training_phase(torch, np, kernels, totals: dict, dev) -> None:
    """Phase 10: ring-all-reduce training at llama3.2-1b's full width, the
    train CLI with a checkpoint reloaded bitwise, and ``sched_launch``'s
    jobs on the card; the kernel counters are zeroed just before the
    launcher runs and read just after."""
    import tempfile

    from repro_torch import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.dist import rar, steps
    from repro_torch.launch import sched_launch, train
    from repro_torch.models import build_model
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    w, B, S, n_steps = (TRAIN[k] for k in ("w", "batch", "seq", "steps"))
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg, max_seq=S, device=dev)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    d = sum(p.numel() for p in leaves(params))
    gb = 4 * d / 1e9
    print(f"training: llama3.2-1b full width, {d} float32 params, "
          f"{cfg.compute_dtype} compute, ring w={w}, global batch {B}, seq "
          f"{S}; reckoned memory: params {gb:.1f} GB, AdamW moments "
          f"{2 * gb:.1f} GB, the [w, d] gradient buffer {w * gb:.1f} GB "
          f"(the all-gather writes back into it)", flush=True)
    ring_phase(torch, rar, d, w, dev)

    # 10b: RAR training steps, each split into fwd+bwd, ring and AdamW.
    ocfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=min(50, n_steps // 10 + 1),
                             total_steps=n_steps)
    opt = adamw.init(ocfg, params)
    step_fn = steps.make_rar_train_step(model, ocfg,
                                        steps.RingMesh(range(w), dev))
    shape = InputShape("train", S, B, "train")
    batches = [make_batch(cfg, shape, i, DataConfig(), device=dev)
               for i in range(n_steps + 1)]
    ring_grad = {}
    ring = steps.ring_all_reduce

    def capture(buf, **kw):
        out = ring(buf, **kw)
        ring_grad["g"] = out[0] / w
        return out

    steps.ring_all_reduce = capture
    params0 = params
    params, opt, metrics = step_fn(params, opt, batches[0])
    steps.ring_all_reduce = ring
    single, _ = steps._grads_and_loss(model, ocfg, params0, batches[0])
    single = torch.cat([g.reshape(-1) for g in leaves(single)])
    gap = float((ring_grad.pop("g") - single).norm() / single.norm())
    del single, params0
    if not gap <= GRAD_GAP_TOL:
        fail(f"training: ring-averaged gradient {gap} from the single-program "
             f"gradient (relative L2), limit {GRAD_GAP_TOL}")
    losses = [float(metrics["loss"])]
    spent, restore = timed_calls(torch, [(steps, "_grads_and_loss"),
                                         (steps, "ring_all_reduce"),
                                         (steps.adamw, "apply")])
    walls = []
    for i in range(1, n_steps):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batches[i])
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if metrics["replicated"] is not True:
            fail(f"training step {i}: the ring's rows differ")
    restore()
    if not all(np.isfinite(losses)):
        fail(f"training: non-finite loss {losses}")
    per_step = sum(walls) / len(walls)
    split = {k: v / len(walls) for k, v in spent.items()}
    split["other"] = per_step - sum(split.values())
    peak = torch.cuda.max_memory_allocated() / 2**30
    holder = {}
    step_wall = wall_s(torch, lambda: holder.update(
        out=step_fn(params, opt, batches[n_steps])))
    params, opt, metrics = holder.pop("out")
    busy, rows = device_busy(torch, lambda: holder.update(
        out=step_fn(params, opt, batches[n_steps])))
    holder.clear()
    print(f"training losses of steps 0-{n_steps - 1}: {losses}; "
          f"ring-averaged vs single-program gradient of step 0: relative L2 "
          f"gap {gap} (limit {GRAD_GAP_TOL})")
    print(f"training: {per_step:.6f} s a step (steps 1-{n_steps - 1}), "
          f"{B * S / per_step:.3f} tokens/s; a step's split: fwd+bwd of "
          f"{w} workers {split['_grads_and_loss']:.6f} s, ring "
          f"{split['ring_all_reduce']:.6f} s, AdamW {split['apply']:.6f} s, "
          f"other (flatten, divide, row check) {split['other']:.6f} s; peak "
          f"device memory {peak:.3f} GiB")
    print(f"device profile of one training step: busy {busy:.6f} s of "
          f"{step_wall:.6f} s wall, idle share {1.0 - busy / step_wall:.6f}")
    for us, count, key in rows[:6]:
        print(f"  device {us / 1e3:.3f} ms in {count} x {key[:70]}")
    del params, opt, metrics, batches, step_fn
    torch.cuda.empty_cache()

    # 10c: the train CLI at full width, a checkpoint reloaded bitwise.
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        res = train.main(["--mode", "rar", "--devices", str(w), "--steps",
                          "3", "--batch", str(B), "--seq", str(S),
                          "--ckpt-every", "2", "--ckpt-dir", tmp,
                          "--log-every", "1", "--device", "cuda"])
        t_cli = time.perf_counter() - t0
        if not all(np.isfinite(res["losses"])) or len(res["checkpoints"]) != 1:
            fail(f"train CLI: losses {res['losses']}, checkpoints "
                 f"{res['checkpoints']}")
        path = res["checkpoints"][0]
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        lp, lo, step = ckpt.load(path, params_like=res["params"],
                                 opt_like=res["opt"])
        t_load = time.perf_counter() - t0
        if step != 2 or not all(
                torch.equal(a, b) and a.device == b.device
                for a, b in zip(leaves(lp) + leaves(lo),
                                leaves(res["params"]) + leaves(res["opt"]))):
            fail("train CLI: the reloaded checkpoint differs")
        del lp, lo, res
    torch.cuda.empty_cache()
    print(f"train CLI full width, 3 RAR steps: {t_cli:.3f} s with one "
          f"checkpoint of {size} bytes; reloaded bitwise in {t_load:.3f} s",
          flush=True)

    # 10d: sched_launch's jobs on the card; the schedule against the CPU's:
    # 3 jobs, then the launcher's defaults (8 GPUs, 2 servers, 6 jobs, 4
    # steps: every family of its pool trains, reduced).
    for argv in (["--devices", "4", "--servers", "2", "--jobs", "3",
                  "--steps", "2"], []):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card = sched_launch.main(argv + ["--device", "cuda"])
        t_card = time.perf_counter() - t0
        counts = kernels.launch_counts()
        host = sched_launch.main(argv + ["--device", "cpu"])
        placed = [[(int(j), [int(g) for g in ids])
                   for j, ids in out["schedule"].assignment]
                  for out in (card, host)]
        same = (placed[0] == placed[1]
                and all(np.array_equal(getattr(card["sim"], f),
                                       getattr(host["sim"], f))
                        for f in ("start", "finish", "makespan", "avg_jct")))
        label = " ".join(argv) or "at its defaults"
        if not same:
            fail(f"sched_launch {label}: the card's schedule differs from "
                 "the CPU's")
        if not all(np.isfinite(v).all() for v in card["losses"].values()):
            fail(f"sched_launch {label}: non-finite losses {card['losses']}")
        for name, n in counts.items():
            totals[name] += n
        print(f"sched_launch {label} on the card: schedule {placed[0]} "
              f"bitwise equal to the CPU's, simulated makespan "
              f"{card['sim'].makespan}; job losses "
              f"{ {j: v for j, v in card['losses'].items()} }; {t_card:.3f} "
              f"s; kernel launches {counts}", flush=True)
    print(f"training phase {time.perf_counter() - t_phase:.6f} s wall",
          flush=True)


# Phase 11: the moe, hybrid and audio families at full width.  K5 at each
# family's bf16 serving shape: batch, q heads, kv heads, seq, hd, causal,
# window.
FAMILY_ATTN = {
    "deepseek-moe-16b": (4, 16, 16, 1024, 128, True, 0),
    "hymba-1.5b": (4, 25, 5, 1024, 64, True, 1024),
    "whisper-tiny encoder": (2, 6, 6, 1500, 64, False, 0),
}


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a mask keeps over S positions."""
    if not causal:
        return S * S
    return sum(min(q + 1, window) if window else q + 1 for q in range(S))


def family_attention_timing(torch, np, dev) -> None:
    """K5 at the three new serving shapes in bf16, in the model layout:
    against its plain version (2e-2), timed beside it and
    ``F.scaled_dot_product_attention`` (the yardstick only), with its
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    for label, (B, H, K, S, hd, causal, window) in FAMILY_ATTN.items():
        rng = np.random.default_rng(S + H)
        q, k, v = (torch.tensor(rng.standard_normal((B, S, n, hd)),
                                dtype=torch.bfloat16, device=dev)
                   .transpose(1, 2) for n in (H, K, K))
        kw = dict(causal=causal, window=window)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=2e-2,
                              atol=2e-2):
            fail(f"K5 at {label} {(B, H, K, S, hd)}: max abs err {err} "
                 "against its plain version exceeds 2e-2")
        # S = 1024 with a 1024 window masks nothing beyond causality, so
        # SDPA's causal mask computes the same function there.
        if window and window < S:
            fail(f"{label}: SDPA has no window mask to compare with")
        lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
        if not torch.allclose(lib().float(), want.float(), rtol=2e-2,
                              atol=2e-2):
            fail(f"{label}: scaled_dot_product_attention disagrees with K5's "
                 "plain version")
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, **kw), reps=10)
        library_ms = time_ms(torch, lib)
        n_bytes = 2 * (2 * B * H * S * hd + 2 * B * K * S * hd)
        n_ops = 4 * B * H * hd * attention_pairs(S, causal, window)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / BF16_OPS_PER_S * 1e3
        print(f"kernel flash_attention bf16 at {label} (B, H, K, S, hd) = "
              f"{(B, H, K, S, hd)} causal {causal} window {window}: within "
              f"2e-2 of plain, max abs err {err}; {ms:.6f} ms/launch, plain "
              f"{plain_ms:.6f} ms, scaled_dot_product_attention "
              f"{library_ms:.6f} ms, bytes {n_bytes}, ops {n_ops}, bound "
              f"{max(bytes_ms, ops_ms):.6f} ms by "
              f"{'bytes' if bytes_ms >= ops_ms else 'operations'}",
              flush=True)
        del q, k, v, got, want
    torch.cuda.empty_cache()


def count_k5_calls(layers) -> tuple[list, object]:
    """Wrap the models' K5 entry point so that each call records its
    ``causal`` flag; returns the record and the undo."""
    real, calls = layers.kops.flash_attention, []

    def counted(*args, **kw):
        calls.append(kw.get("causal", True))
        return real(*args, **kw)

    layers.kops.flash_attention = counted
    return calls, lambda: setattr(layers.kops, "flash_attention", real)


def moe_routing(moe, cfg, p, h2):
    """Per token of h2 [B, S, d]: the [T, E] routed and routed-and-kept
    expert masks of ``moe_apply`` with ``cfg``'s capacity."""
    import torch
    xt = h2.reshape(-1, h2.shape[-1])
    T, E = xt.shape[0], cfg.n_experts
    _, _, top_i = moe.route(cfg, p, xt)
    order, keep, _ = moe.dispatch(top_i, E, moe.capacity(cfg, T))
    kept = torch.empty_like(keep)
    kept[order] = keep
    routed = torch.zeros((T, E), dtype=torch.bool, device=xt.device)
    routed.scatter_(1, top_i, True)
    held = torch.zeros_like(routed)
    held.scatter_(1, top_i, kept.view_as(top_i))
    return routed, held


def moe_per_block_checks(torch, transformer, moe, model, params, toks):
    """One float32 prefill with K5 on in which every block also runs with
    K5 off on the same input; each block's outputs agree within 2e-4 over
    the tokens that both runs route to the same experts and keep (a token
    whose top-k set or kept set differs is a near tie of router scores,
    counted, not gated).  Returns the logits, the worst difference and the
    flipped share of (token, MoE layer) pairs."""
    import dataclasses
    cfg_off = dataclasses.replace(model.config, use_flash_kernel=False)
    real_block, real_moe = transformer.block_apply, transformer.moe_apply
    stats = {"worst": 0.0, "flipped": 0, "pairs": 0}

    def checked(cfg_, p, x, *args, kind="dense", **kw):
        seen = []

        def spy(c, pm, h2):
            seen.append(h2)
            return real_moe(c, pm, h2)

        transformer.moe_apply = spy
        try:
            on = real_block(cfg_, p, x, *args, kind=kind, **kw)
            off = real_block(cfg_off, p, x, *args, kind=kind, **kw)
        finally:
            transformer.moe_apply = real_moe
        agree = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        if kind == "moe":
            r_on, k_on = moe_routing(moe, cfg_, p["moe"], seen[0])
            r_off, k_off = moe_routing(moe, cfg_, p["moe"], seen[1])
            agree = ((r_on == r_off).all(1) & (k_on == k_off).all(1)
                     ).view(x.shape[:2])
            stats["flipped"] += int((~agree).sum())
            stats["pairs"] += agree.numel()
        diff = float((on[0] - off[0]).abs()[agree].max())
        stats["worst"] = max(stats["worst"], diff)
        if not torch.allclose(on[0][agree], off[0][agree], rtol=2e-4,
                              atol=2e-4):
            fail(f"deepseek f32 {kind} block: K5 on vs off max abs diff "
                 f"{diff} exceeds 2e-4 over identically routed tokens")
        return on

    transformer.block_apply = checked
    try:
        logits = model.prefill(params, {"tokens": toks})
    finally:
        transformer.block_apply = real_block
    torch.cuda.synchronize()
    return logits, stats["worst"], stats["flipped"] / max(stats["pairs"], 1)


def routed_sets(moe, record):
    """Wrap ``moe.route`` so that each call appends its [T, k] expert ids,
    sorted per token, to ``record``; returns the undo."""
    real = moe.route

    def spy(cfg, p, xt):
        out = real(cfg, p, xt)
        record.append(out[2].sort(dim=-1).values)
        return out

    moe.route = spy
    return lambda: setattr(moe, "route", real)


def decode_positions(torch, model, params, toks, n: int, frames=None):
    """Logits [B, n, V] of n stepped decode positions from an empty cache
    (audio: the encoder output of ``frames`` pinned into it first)."""
    B = toks.shape[0]
    cache = model.init_cache(B, n)
    if frames is not None:
        cache["enc_out"] = model.encode(params, frames)
    out = []
    for pos in range(n):
        lg, cache = model.decode_step(
            params, cache, toks[:, pos],
            torch.full((B,), pos, dtype=torch.int32, device=toks.device))
        out.append(lg)
    return torch.stack(out, dim=1)


def bf16_gate(torch, name, on, off, ref, gate: bool) -> str:
    """K5 on and off bf16 logits against a float32 K5-off prefill of the
    same inputs: max abs distances; K5 on may be no farther than 1.5x K5
    off where ``gate``."""
    d_on, d_off = (max(float((lg[b].float() - ref[b]).abs().max())
                       for b in range(lg.shape[0])) for lg in (on, off))
    if gate and not d_on <= 1.5 * d_off:
        fail(f"{name} bf16 prefill: K5 on is {d_on} from the float32 "
             f"prefill, more than 1.5x K5 off's {d_off}")
    return (f"max abs logit distance to a float32 K5-off prefill: K5 on "
            f"{d_on}, K5 off {d_off}"
            + (" (limit: on <= 1.5x off)" if gate else
               " (printed, not gated: routing flips dominate both)"))


def serve_cli(torch, serve, arch: str, dev, V: int) -> None:
    """The serve CLI at its defaults (batch 4, prompt 16, 32 tokens)."""
    res = serve.main(["--arch", arch, "--device", str(dev)])
    tokens, logits = res["tokens"], res["logits"]
    if not bool(torch.isfinite(logits).all()):
        fail(f"{arch} serve loop: non-finite logits")
    if tokens.shape != (4, 32) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= V:
        fail(f"{arch} serve loop: tokens {tuple(tokens.shape)} outside "
             f"[0, {V})")
    print(f"serve loop {arch} full width bf16: prefill (15 stepped "
          f"positions) {res['prefill_s']:.6f} s, decode {res['decode_s']:.6f}"
          f" s, {4 * 32 / res['decode_s']:.3f} tok/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del res
    torch.cuda.empty_cache()


def timed_prefills(torch, on, off, params, batch, runs: list):
    """bf16 K5-on (after a warm-up) and K5-off prefills: their logits and
    wall seconds."""
    holder = {}
    on.prefill(params, batch)                               # warm-up
    t_on = wall_s(torch, lambda: holder.update(on=on.prefill(params, batch)))
    t_off = wall_s(torch, lambda: holder.update(
        off=off.prefill(params, batch)))
    runs[0] += 2                  # the warm-up and the timed run
    return holder["on"], holder["off"], t_on, t_off


def deepseek_case(torch, np, dev, runs: list) -> None:
    """11(a): deepseek-moe-16b at full width (16.4e9 float32 params)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model, moe, transformer

    base = dataclasses.replace(get_config("deepseek-moe-16b"),
                               use_flash_kernel=True)
    V, E = base.vocab, base.n_experts
    rng = np.random.default_rng(11)
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    on = build_model(cfg32, device=dev)
    t0 = time.perf_counter()
    params = on.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"families: deepseek-moe-16b full width, {n_params} float32 params "
          f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB) from "
          f"torch.Generator seed 0 in {time.perf_counter() - t0:.3f} s",
          flush=True)
    toks = torch.tensor(rng.integers(0, V, (2, 256)), dtype=torch.int32,
                        device=dev)
    lg_on, worst, flipped = moe_per_block_checks(torch, transformer, moe, on,
                                                 params, toks)
    runs[0] += 1
    if flipped > 1e-3:
        fail(f"deepseek f32: {flipped} of (token, MoE layer) pairs route "
             "differently with K5 on and off, limit 1e-3")
    lg_off = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                         device=dev).prefill(params, {"tokens": toks})
    if not torch.isfinite(lg_on).all() or lg_on.shape != (2, 256, V):
        fail(f"deepseek f32 prefill: logits {tuple(lg_on.shape)} not finite")
    print(f"deepseek f32 B=2 S=256, capacity factor {base.capacity_factor}, "
          f"each of the {base.n_layers} blocks on the K5 prefill's own "
          f"inputs: K5 on vs "
          f"off max abs diff {worst} over identically routed and kept "
          f"tokens (within rtol = atol = 2e-4); (token, MoE layer) pairs "
          f"routed differently: share {flipped} (limit 1e-3); whole prefill "
          f"K5 on vs off max abs logit diff "
          f"{float((lg_on - lg_off).abs().max())} (printed, not gated)",
          flush=True)
    del lg_on, lg_off

    # Decode vs prefill with no dropping (capacity factor = n_experts, as
    # reduced() has it): a dropping prefill and a 2-token decode keep
    # different tokens.
    nodrop = build_model(dataclasses.replace(cfg32, capacity_factor=float(E)),
                         device=dev)
    pre, dec = [], []
    undo = routed_sets(moe, pre)
    try:
        full = nodrop.prefill(params, {"tokens": toks})
    finally:
        undo()
    runs[0] += 1
    undo = routed_sets(moe, dec)
    try:
        steps = decode_positions(torch, nodrop, params, toks, 16)
    finally:
        undo()
    L = len(pre)
    B, S = toks.shape
    same = torch.ones((B, 16), dtype=torch.bool, device=dev)
    for s in range(16):
        for layer in range(L):
            p_ids = pre[layer].view(B, S, -1)[:, s]
            same[:, s] &= (p_ids == dec[s * L + layer]).all(-1)
    same = same.cumprod(dim=1).bool()          # a flip reaches later tokens
    diff = float((steps - full[:, :16]).abs()[same].max())
    if not torch.allclose(steps[same], full[:, :16][same], rtol=2e-2,
                          atol=2e-2):
        fail(f"deepseek f32 no-drop decode: 16 stepped positions vs the "
             f"prefill max abs diff {diff} exceeds 2e-2")
    print(f"deepseek f32 decode vs prefill, capacity factor {float(E)} (no "
          f"drop: a dropping prefill and a 2-token decode keep different "
          f"tokens): 16 stepped positions max abs diff {diff} (limit 2e-2) "
          f"over {int(same.sum())} of {same.numel()} positions routed alike "
          f"in all {L} MoE layers", flush=True)
    del full, steps, pre, dec

    # bf16 compute (the config's own): timed prefill, K5 on vs off.
    on = build_model(base, device=dev)
    off = build_model(dataclasses.replace(base, use_flash_kernel=False),
                      device=dev)
    batch = {"tokens": torch.tensor(rng.integers(0, V, (4, 1024)),
                                    dtype=torch.int32, device=dev)}
    lg_on, lg_off, t_on, t_off = timed_prefills(torch, on, off, params, batch,
                                                runs)
    if not bool(torch.isfinite(lg_on).all()):
        fail("deepseek bf16 prefill: non-finite logits")
    agree = float((lg_on.argmax(-1) == lg_off.argmax(-1)).float().mean())
    ref = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                      device=dev).prefill(params, batch)
    print(f"deepseek bf16 B=4 S=1024 prefill: K5 on {t_on:.6f} s, K5 off "
          f"{t_off:.6f} s, {4 * 1024 / t_on:.3f} tokens/s; K5 on vs off "
          f"argmax agreement {agree}; "
          f"{bf16_gate(torch, 'deepseek', lg_on, lg_off, ref, False)}",
          flush=True)
    del lg_on, lg_off, ref
    spent = split_seconds(torch, transformer, ["moe_apply"])
    try:
        t_split = wall_s(torch, lambda: on.prefill(params, batch))
    finally:
        transformer.moe_apply = moe.moe_apply
    runs[0] += 1
    busy, rows = device_busy(torch, lambda: on.prefill(params, batch))
    runs[0] += 1
    print(f"deepseek bf16 prefill split (each MoE layer synchronised): "
          f"moe_apply {spent['moe_apply']:.6f} s of {t_split:.6f} s, share "
          f"{spent['moe_apply'] / t_split:.6f}; device profile: busy "
          f"{busy:.6f} s of {t_on:.6f} s wall, idle share "
          f"{1.0 - busy / t_on:.6f}", flush=True)
    for us, count, key in rows[:6]:
        print(f"  device {us / 1e3:.3f} ms in {count} x {key[:70]}")
    del params, on, off, batch
    torch.cuda.empty_cache()
    serve_cli(torch, serve, "deepseek-moe-16b", dev, V)


def hymba_case(torch, np, dev, runs: list) -> None:
    """11(b): hymba-1.5b at full width."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model, transformer

    base = dataclasses.replace(get_config("hymba-1.5b"),
                               use_flash_kernel=True)
    V = base.vocab
    rng = np.random.default_rng(12)
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    on = build_model(cfg32, device=dev)
    off = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                      device=dev)
    params = on.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"families: hymba-1.5b full width, {n_params} float32 params; "
          f"windows {transformer.layer_windows(base)}", flush=True)
    toks = torch.tensor(rng.integers(0, V, (2, 2048)), dtype=torch.int32,
                        device=dev)
    lg_on = on.prefill(params, {"tokens": toks})
    runs[0] += 1
    lg_off = off.prefill(params, {"tokens": toks})
    diff = float((lg_on - lg_off).abs().max())
    if not torch.isfinite(lg_on).all() or not torch.allclose(
            lg_on, lg_off, rtol=2e-4, atol=2e-4):
        fail(f"hymba f32 prefill: K5 on vs off max abs diff {diff} exceeds "
             "2e-4")
    dec = decode_positions(torch, on, params, toks, 16)
    dec_diff = float((dec - lg_on[:, :16]).abs().max())
    if not torch.allclose(dec, lg_on[:, :16], rtol=2e-2, atol=2e-2):
        fail(f"hymba f32 decode: 16 stepped positions (Mamba's recurrence) "
             f"vs the K5 prefill (its scan) max abs diff {dec_diff} exceeds "
             "2e-2")
    print(f"hymba f32 B=2 S=2048 (the 1024 windows bite): prefill K5 on vs "
          f"off max abs diff {diff} (limit 2e-4); 16 decode steps vs K5 "
          f"prefill max abs diff {dec_diff} (limit 2e-2); logits |max| "
          f"{float(lg_on.abs().max())}", flush=True)
    del lg_on, lg_off, dec

    on = build_model(base, device=dev)
    off = build_model(dataclasses.replace(base, use_flash_kernel=False),
                      device=dev)
    batch = {"tokens": torch.tensor(rng.integers(0, V, (4, 1024)),
                                    dtype=torch.int32, device=dev)}
    lg_on, lg_off, t_on, t_off = timed_prefills(torch, on, off, params, batch,
                                                runs)
    if not bool(torch.isfinite(lg_on).all()):
        fail("hymba bf16 prefill: non-finite logits")
    ref = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                      device=dev).prefill(params, batch)
    print(f"hymba bf16 B=4 S=1024 prefill: K5 on {t_on:.6f} s, K5 off "
          f"{t_off:.6f} s, {4 * 1024 / t_on:.3f} tokens/s; "
          f"{bf16_gate(torch, 'hymba', lg_on, lg_off, ref, True)}",
          flush=True)
    del lg_on, lg_off, ref
    parts = {n: getattr(transformer, n) for n in ("attention", "mamba_seq")}
    spent = split_seconds(torch, transformer, parts)
    try:
        t_split = wall_s(torch, lambda: on.prefill(params, batch))
    finally:
        for name, fn in parts.items():
            setattr(transformer, name, fn)
    runs[0] += 1
    busy, rows = device_busy(torch, lambda: on.prefill(params, batch))
    runs[0] += 1
    print(f"hymba bf16 prefill split (each block part synchronised): "
          f"attention {spent['attention']:.6f} s, Mamba "
          f"{spent['mamba_seq']:.6f} s, of {t_split:.6f} s; device profile: "
          f"busy {busy:.6f} s of {t_on:.6f} s wall, idle share "
          f"{1.0 - busy / t_on:.6f}", flush=True)
    for us, count, key in rows[:6]:
        print(f"  device {us / 1e3:.3f} ms in {count} x {key[:70]}")
    del params, on, off, batch
    torch.cuda.empty_cache()
    serve_cli(torch, serve, "hymba-1.5b", dev, V)


def whisper_case(torch, np, dev, runs: list) -> None:
    """11(c): whisper-tiny at full width, built with max_seq 448 (Whisper's
    decoder context); K5 on the encoder (non-causal) and on the decoder's
    self-attention (causal), never on cross-attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model, layers

    base = dataclasses.replace(get_config("whisper-tiny"),
                               use_flash_kernel=True)
    V, F_, d = base.vocab, base.enc_frames, base.d_model
    rng = np.random.default_rng(13)

    def inputs(dtype_seed):
        r = np.random.default_rng(dtype_seed)
        return {"tokens": torch.tensor(r.integers(0, V, (2, 256)),
                                       dtype=torch.int32, device=dev),
                "frames": torch.tensor(r.standard_normal((2, F_, d)),
                                       dtype=torch.float32, device=dev)}

    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    on = build_model(cfg32, max_seq=448, device=dev)
    off = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                      max_seq=448, device=dev)
    params = on.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"families: whisper-tiny full width, {n_params} float32 params, "
          f"max_seq 448", flush=True)
    batch = inputs(14)
    calls, undo = count_k5_calls(layers)
    try:
        lg_on = on.prefill(params, batch)
    finally:
        undo()
    runs[0] += 1
    if calls != [False] * base.n_enc_layers + [True] * base.n_layers:
        fail(f"whisper prefill: K5 calls (causal flags) {calls}, expected "
             f"{base.n_enc_layers} non-causal then {base.n_layers} causal and "
             "none for cross-attention")
    lg_off = off.prefill(params, batch)
    diff = float((lg_on - lg_off).abs().max())
    if not torch.isfinite(lg_on).all() or not torch.allclose(
            lg_on, lg_off, rtol=2e-4, atol=2e-4):
        fail(f"whisper f32 encode + prefill: K5 on vs off max abs diff "
             f"{diff} exceeds 2e-4")
    dec = decode_positions(torch, on, params, batch["tokens"], 16,
                           frames=batch["frames"])
    runs[1] += 1                  # its encoder ran K5 once a layer
    dec_diff = float((dec - lg_on[:, :16]).abs().max())
    if not torch.allclose(dec, lg_on[:, :16], rtol=2e-2, atol=2e-2):
        fail(f"whisper f32 decode: 16 stepped positions vs the K5 prefill "
             f"max abs diff {dec_diff} exceeds 2e-2")
    print(f"whisper f32 frames [2, {F_}, {d}], decoder S=256: encode + "
          f"prefill K5 on vs off max abs diff {diff} (limit 2e-4); 16 decode "
          f"steps vs K5 prefill max abs diff {dec_diff} (limit 2e-2); K5 "
          f"calls a prefill: {calls.count(False)} non-causal (encoder), "
          f"{calls.count(True)} causal (decoder), 0 cross-attention",
          flush=True)
    del lg_on, lg_off, dec

    on = build_model(base, max_seq=448, device=dev)
    off = build_model(dataclasses.replace(base, use_flash_kernel=False),
                      max_seq=448, device=dev)
    batch = inputs(15)
    lg_on, lg_off, t_on, t_off = timed_prefills(torch, on, off, params, batch,
                                                runs)
    if not bool(torch.isfinite(lg_on).all()):
        fail("whisper bf16 prefill: non-finite logits")
    ref = build_model(dataclasses.replace(cfg32, use_flash_kernel=False),
                      max_seq=448, device=dev).prefill(params, batch)
    busy, rows = device_busy(torch, lambda: on.prefill(params, batch))
    runs[0] += 1
    print(f"whisper bf16 encode + prefill (frames [2, {F_}, {d}], S=256): K5 "
          f"on {t_on:.6f} s, K5 off {t_off:.6f} s; "
          f"{bf16_gate(torch, 'whisper', lg_on, lg_off, ref, True)}; device "
          f"profile: busy {busy:.6f} s of {t_on:.6f} s wall, idle share "
          f"{1.0 - busy / t_on:.6f}", flush=True)
    for us, count, key in rows[:6]:
        print(f"  device {us / 1e3:.3f} ms in {count} x {key[:70]}")
    del params, on, off, batch, lg_on, lg_off, ref
    torch.cuda.empty_cache()
    serve_cli(torch, serve, "whisper-tiny", dev, V)


def families_phase(torch, np, kernels, totals: dict, dev) -> None:
    """Phase 11: deepseek-moe-16b, hymba-1.5b and whisper-tiny at full
    width through prefill (K5 on) and the serve CLI, from an empty
    allocator; K5 first at their three bf16 serving shapes.  The counters
    are zeroed just before the models run and read just after."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    print(f"families: device memory allocated at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    from repro_torch.configs import get_config
    family_attention_timing(torch, np, dev)
    for arch, case in (("deepseek-moe-16b", deepseek_case),
                       ("hymba-1.5b", hymba_case),
                       ("whisper-tiny", whisper_case)):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        runs = [0, 0]                    # K5 prefills, encoder runs alone
        case(torch, np, dev, runs)
        counts = kernels.launch_counts()
        # K5 launches a prefill (one per self-attention layer: 28, 32, and
        # whisper's 4 + 4) and an encoder run alone (whisper's 4).
        cfg = get_config(arch)
        per_encode = cfg.n_enc_layers
        per_prefill = cfg.n_layers + per_encode
        if counts["flash_attention"] != per_prefill * runs[0] \
                + per_encode * runs[1]:
            fail(f"{arch}: K5 launched {counts['flash_attention']} times, "
                 f"expected {per_prefill} per K5 prefill x {runs[0]} + "
                 f"{per_encode} per encoder run x {runs[1]}")
        for name, n in counts.items():
            totals[name] += n
        print(f"families {arch}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"launches {counts}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"families phase {time.perf_counter() - t_phase:.6f} s wall",
          flush=True)


# Phase 12 (a): full-width dry-run pairs on fake CUDA tensors, as
# (arch, shape, multi_pod).
DRYRUN_PAIRS = (("llama3.2-1b", "train_4k", False),
                ("llama3.2-1b", "prefill_32k", False),
                ("llama3.2-1b", "decode_32k", False),
                ("deepseek-moe-16b", "train_4k", False),
                ("hymba-1.5b", "long_500k", False),
                ("whisper-tiny", "train_4k", False),
                ("xlstm-350m", "decode_32k", False),
                ("llama3-405b", "train_4k", True),
                ("hymba-1.5b", "decode_32k", False),
                ("xlstm-350m", "prefill_32k", False),
                ("xlstm-350m", "train_4k", True))
# Phase 12 (b): llama3.2-1b on one real rank, (shape, batch) that fit in
# 80 GB.
ONE_RANK = (("train_4k", 1), ("prefill_32k", 1), ("decode_32k", 16))


def dryrun_row(tag: str, row: dict) -> None:
    print(f"dryrun {tag} {row['arch']} x {row['shape']} x {row['mesh']}: "
          f"mem/device {row['hbm_peak_bytes'] / 2**30:.6f} GiB of 80 "
          f"(inputs {row['args_bytes'] / 2**30:.6f}), flops/device "
          f"{row['hlo_flops']:.6e}, bytes/device {row['hlo_bytes']:.6e}, "
          f"collective {row['collective_bytes']:.6e} B "
          f"{row['collective_counts']}, dcn {row['dcn_bytes']:.6e} B; "
          f"t_compute {row['t_compute_s']:.6e} s, t_memory "
          f"{row['t_memory_s']:.6e} s, t_collective "
          f"{row['t_collective_s']:.6e} s, bottleneck {row['bottleneck']}; "
          f"run {row['run_s']:.3f} s", flush=True)


def dryrun_phase(torch, kernels) -> None:
    """Phase 12: the production-mesh dry-run on fake CUDA tensors at full
    width, then llama3.2-1b on one real rank, fake against real."""
    import gc
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    for arch, shape, multi_pod in DRYRUN_PAIRS:
        row = dryrun.run_pair(arch, shape, multi_pod=multi_pod,
                              device="cuda", verbose=False)
        dryrun_row("(a)", row)
        if not (row["hlo_flops"] > 0 and row["hlo_bytes"] > 0):
            fail(f"dry-run {arch} x {shape}: no FLOPs or bytes counted")
        if row["collective_bytes"] <= 0:
            fail(f"dry-run {arch} x {shape}: a sharded step sent nothing")
        if multi_pod and shape == "train_4k" and row["dcn_bytes"] <= 0:
            fail(f"dry-run {arch} x train_4k: no bytes crossed pods")
        if arch == "xlstm-350m" and shape == "train_4k" and \
                row["hlo_flops"] < 0.5 * row["model_flops"] / row["chips"]:
            fail(f"dry-run xlstm-350m x train_4k: {row['hlo_flops']} FLOPs "
                 f"a device, under half of 6 N D over {row['chips']}")
    whole = sum(t.numel() * t.element_size() for t in leaves(
        build_model(get_config("internvl2-1b"), device="meta").init(0)))
    os.environ["REPRO_NAIVE_SHARDING"] = "1"
    try:
        naive = dryrun.run_pair("internvl2-1b", "prefill_32k",
                                device="cuda", verbose=False)
    finally:
        del os.environ["REPRO_NAIVE_SHARDING"]
    dryrun_row("(a) naive", naive)
    opt = dryrun.run_pair("internvl2-1b", "prefill_32k", device="cuda",
                          verbose=False)
    dryrun_row("(a) optimized", opt)
    print(f"dryrun internvl2-1b params: {whole} B whole, naive "
          f"{naive['param_bytes']:.0f} B, optimized {opt['param_bytes']:.0f}"
          f" B a device", flush=True)
    if naive["param_bytes"] != whole:
        fail("naive internvl2-1b does not hold every param byte a device")
    if opt["param_bytes"] > whole / 16:
        fail("optimized internvl2-1b holds more than 1/16 of the params")
    counts = kernels.launch_counts()
    if any(counts.values()):
        fail(f"the dry-run launched kernels: {counts}")
    dist.destroy_process_group()

    # (b) one real rank: fake against real at the same batch
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        for shape, batch in ONE_RANK:
            fake = dryrun.dry_run("llama3.2-1b", shape, mesh,
                                  batch_override=batch)
            dryrun_row(f"(b) fake B={batch}", fake)
            gc.collect()
            torch.cuda.empty_cache()
            real = dryrun.dry_run("llama3.2-1b", shape, mesh,
                                  batch_override=batch, fake=False)
            dryrun_row(f"(b) real B={batch}", real)
            gc.collect()
            torch.cuda.empty_cache()
            f_above = fake["hbm_peak_bytes"] - fake["args_bytes"]
            r_above = real["hbm_peak_bytes"] - real["args_bytes"]
            share = max(real["t_compute_s"], real["t_memory_s"]) \
                / real["wall_s"]
            print(f"dryrun (b) llama3.2-1b x {shape} B={batch}: wall "
                  f"{real['wall_s']:.6f} s, roofline share {share:.6f} "
                  f"(max(t_compute, t_memory) / wall); peak above the "
                  f"inputs fake {f_above / 2**30:.6f} GiB, card "
                  f"{r_above / 2**30:.6f} GiB", flush=True)
            if fake["hlo_flops"] != real["hlo_flops"]:
                fail(f"one rank {shape}: fake {fake['hlo_flops']} FLOPs, "
                     f"real {real['hlo_flops']}")
            if fake["collective_counts"] != real["collective_counts"]:
                fail(f"one rank {shape}: collectives differ")
            if abs(f_above - r_above) > 0.1 * r_above:
                fail(f"one rank {shape}: fake peak {f_above} B above the "
                     f"inputs, card {r_above} B")
    finally:
        dist.destroy_process_group()
    print(f"dryrun phase {time.perf_counter() - t_phase:.6f} s wall",
          flush=True)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        fail("src/repro_torch is missing: run from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch
    import repro_torch.core as rt
    from repro_torch import kernels
    from repro_torch.kernels import _build
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        fail(f"imported repro_torch from {repro_torch.__file__}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; card: {smi}", flush=True)

    seconds = _build.build()
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(w in line.lower() for w in ("ptxas", "spill", "error")):
                print(f"nvcc {name}.cu: {line.strip()}")
    print(f"build: {len(_build.BUILD_LOGS)} sources in {seconds:.3f} s",
          flush=True)

    dev = repro_torch.resolve_device("cuda")
    launch_floor(torch, dev)
    rows = kernel_phase(torch, np, rt, dev)
    sass_counts("placement", "_kernel", {
        "DSETP": ("DSETP",), "DADD": ("DADD",), "DMUL": ("DMUL",),
        "DFMA": ("DFMA",), "SHFL": ("SHFL",), "LDS": ("LDS",),
        "BAR": ("BAR.SYNC",)}, "K3/K4")
    tau_scale_point(torch, np, rt, dev)
    rows.append(flash_phase(torch, np, dev))
    rows.append(mlstm_phase(torch, np, dev))
    rows.extend(rmsnorm_swiglu_phase(torch, np, dev))
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    end_to_end_phase(torch, rt, kernels, totals)
    # After the timed runs: torch.profiler's tracer may stay attached.
    entry_point_copies(torch, np, rt, dev)
    serving_phase(torch, np, kernels, totals, dev)
    xlstm_phase(torch, np, kernels, totals, dev)
    entry_point_phase(torch, np, kernels, totals, dev)
    service_phase(torch, np, rt, kernels, totals)
    training_phase(torch, np, kernels, totals, dev)
    families_phase(torch, np, kernels, totals, dev)
    dryrun_phase(torch, kernels)
    for row in rows:
        row["launches"] = totals[row["name"]]
        if row["launches"] <= 0:
            fail(f"kernel {row['name']} never ran on the main path")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
