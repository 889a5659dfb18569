#!/usr/bin/env python3
"""Design probes of the mLSTM kernel (K6) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 chip_probes/k6_design.py

It builds the port's K6 (``src/repro_torch/kernels/csrc/mlstm.cu``) and,
from ``chip_probes/mlstm_3xtf32.cu``, the same function with both
products as 3xTF32 on the tensor cores (base, ``FLUSH``, ``FLUSH
RNA_LO``, ``FLUSH RNA_LO FOURTERM``), and for each prints:

  * ms per launch at xlstm-350m's prefill shape (B 4, H 4, S 1024, hd 512,
    float32, the model layout), CUDA events over back-to-back launches,
    in turns;
  * the gate ratio against the plain version there, max |got - plain| /
    (2e-4 + 2e-4 |plain|) (<= 1 passes the kernel gate);
  * on a near-cancelling case (chip_smoke.py's), the same ratio against
    the plain version in float64;
  * on xlstm-350m at full width, float32, B 2, S 1024 (chip_smoke.py's
    weights and tokens), the worst ratio of the 18 mLSTM blocks with the
    kernel against the same block with K6 off: chip_smoke.py's per-block
    gate (<= 1 passes);
  * whether two launches on the same values, and on copies of them, agree
    bit for bit (the port's kernel).

Then the mma.sync m16n8k8 TF32 rate of ``chip_probes/mma_peak.cu`` at 8,
16 and 32 warps an SM, and one chain's latency.  Every line names the
card and its power limit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBES = ROOT / "chip_probes"
VARIANTS = {"3xtf32": [], "3xtf32 flush": ["-DFLUSH"],
            "3xtf32 flush rna": ["-DFLUSH", "-DRNA_LO"],
            "3xtf32 flush rna 4-term": ["-DFLUSH", "-DRNA_LO", "-DFOURTERM"]}


def build(src: Path, out: Path, flags: list, nvcc: str, nvcc_flags) -> None:
    r = subprocess.run([nvcc, *nvcc_flags, *flags, "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"nvcc failed on {src.name} {flags}:\n{r.stdout}{r.stderr}")


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("k6_design: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mlstm as ml
    from repro_torch.models import build_model, xlstm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    _build.build(["mlstm"])
    libs = {"port (fp32 CUDA cores)": _build.load("mlstm", ml._SIGNATURES)}
    out_dir = _build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, flags in VARIANTS.items():
        so = out_dir / f"mlstm_{'_'.join(name.split())}.so"
        build(PROBES / "mlstm_3xtf32.cu", so, flags, _build.nvcc(),
              _build.NVCC_FLAGS)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in ml._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mlstm_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    def use(lib):
        _build._LIBS["mlstm"] = lib

    def ratio(got, want):
        got, want = got.double(), want.double()
        return float(((got - want).abs() / (2e-4 + 2e-4 * want.abs())).max())

    # The prefill shape in the model layout, as chip_smoke.py makes it.
    B, H, S, hd = chip_smoke.XLSTM_MLSTM
    rng = np.random.default_rng(1)
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * H * hd)),
                       dtype=torch.float32, device=dev)
    q, k, v = (t.reshape(B, S, H, hd) for t in qkv.chunk(3, dim=-1))
    gates = torch.tensor(rng.standard_normal((B, S, 2 * H)),
                         dtype=torch.float32, device=dev)
    i, f = gates.chunk(2, dim=-1)
    F = torch.cumsum(torch.nn.functional.logsigmoid(f + 3.0), dim=1)
    args = (q, k, v / hd ** 0.5, F, i)
    plain = ml.mlstm_parallel_plain(
        *(t.transpose(1, 2) for t in args)).transpose(1, 2)
    cancel = chip_smoke.cancelling_inputs(torch, np, dev, 2, 1024, 512, 0)
    exact = ml.mlstm_parallel_plain(*cancel, dtype=torch.float64)

    rows = {}
    for name, lib in libs.items():
        use(lib)
        got = ops.mlstm(*args)
        c = ml.mlstm_parallel(*cancel)
        torch.cuda.synchronize()
        rows[name] = {"prefill": ratio(got, plain), "cancel": ratio(c, exact)}
    use(libs["port (fp32 CUDA cores)"])
    same = [ops.mlstm(*args) for _ in range(2)] + [
        ops.mlstm(*(t.clone() for t in args))]
    torch.cuda.synchronize()
    print(f"port kernel: repeated and copied launches bitwise equal: "
          f"{all(torch.equal(same[0], y) for y in same[1:])}", flush=True)
    order = list(libs) + list(libs)[::-1]
    times = {name: [] for name in libs}
    for name in order:
        use(libs[name])
        times[name].append(chip_smoke.time_ms(
            torch, lambda: ops.mlstm(*args), reps=50))

    # xlstm-350m at full width, float32: each mLSTM block, K6 on vs off.
    cfg = dataclasses.replace(get_config("xlstm-350m"),
                              use_flash_kernel=True, compute_dtype="float32")
    cfg_off = dataclasses.replace(cfg, use_flash_kernel=False)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 1024)), dtype=torch.int32, device=dev)
    seq = xlstm.mlstm_seq
    for name, lib in libs.items():
        use(lib)
        worst = [0.0]

        def checked(cfg_, p, x):
            y = seq(cfg_, p, x)
            worst[0] = max(worst[0], ratio(y, seq(cfg_off, p, x)))
            return y

        xlstm.mlstm_seq = checked
        try:
            model.prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
        finally:
            xlstm.mlstm_seq = seq
        rows[name]["blocks"] = worst[0]
    use(libs["port (fp32 CUDA cores)"])
    for name, r in rows.items():
        print(f"{name}: {' / '.join(f'{t:.6f}' for t in times[name])} ms "
              f"at {chip_smoke.XLSTM_MLSTM}; gate ratio vs plain "
              f"{r['prefill']:.4f}; near-cancelling vs float64 "
              f"{r['cancel']:.4f}; xlstm-350m blocks, K6 on vs off "
              f"{r['blocks']:.4f} (<= 1 passes) [{card}]", flush=True)

    # mma.sync m16n8k8 TF32: rate and one chain's latency.
    so = out_dir / "mma_peak.so"
    build(PROBES / "mma_peak.cu", so, [], _build.nvcc(), _build.NVCC_FLAGS)
    peak = ctypes.CDLL(str(so))
    peak.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    buf = torch.empty(132 * 1024 * 2, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nacc, blocks, threads, iters in (
            (8, sms, 256, 4000), (8, sms, 512, 2000), (8, 2 * sms, 512, 1000),
            (1, sms, 32, 4000)):
        peak.run(nacc, blocks, threads, 10, buf.data_ptr())
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        peak.run(nacc, blocks, threads, iters, buf.data_ptr())
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        n = blocks * threads // 32 * iters * nacc
        print(f"mma.sync m16n8k8 tf32, {nacc} chain(s) a warp, "
              f"{blocks * threads // 32 // sms} warps an SM: "
              f"{n * 2048 / ms / 1e9:.1f} TFLOP/s, "
              f"{ms * 1e6 / (iters * nacc):.2f} ns per mma a warp [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
