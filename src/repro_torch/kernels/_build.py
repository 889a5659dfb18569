"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers)
and compiles with one ``nvcc`` call into
``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root; the
hash covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  :func:`build` starts one nvcc per missing
library, all at once, and waits for them.

``-fmad=false`` is part of the scheduler kernels' bit-identity contract:
they must round every float64 product and sum separately, as NumPy does.
The attention, mLSTM, RMSNorm and SwiGLU kernels, held to a tolerance,
fuse their products with explicit ``fmaf`` calls, which the flag leaves
alone.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("tau", "placement", "flash_attention", "mlstm", "rmsnorm",
           "swiglu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: nvcc's output (the ``-Xptxas -v`` register/shared-memory lines) per
#: source built by this process.
BUILD_LOGS: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every source in ``names`` whose library is missing, one nvcc
    per source, all started together.  Returns the wall seconds taken;
    raises with nvcc's output if any compile fails."""
    todo = [(n, library_path(n)) for n in names
            if not library_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, building every source on
    first use; ``signatures`` maps each C entry point to its ``argtypes``
    (every pointer and the stream as ``c_void_p``), each returning the
    ``cudaError_t`` of its launch as ``int``."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(name: str, signatures: dict[str, list], fn: str,
           device: torch.device, *args) -> None:
    """Call the C entry point ``fn`` of ``csrc/<name>.cu`` on ``device``'s
    current stream (appended as the last argument) and raise on a launch
    error."""
    lib = load(name, signatures)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: {msg} "
                           f"(error {err})")


def check(t, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` -- what every kernel wrapper takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when autograd would record a call of ``kernel``: grad mode is
    on and one of ``tensors`` requires grad.

    The CUDA kernels have no backward (nor have the reference's Pallas
    kernels), so their output would carry no ``grad_fn`` and a training
    step would run on silently wrong gradients.  The plain PyTorch
    versions, which the wrappers run on CPU tensors, are differentiable
    and never reach this check."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or on tensors that do not require grad (the "
            "models train with use_flash_kernel=False)")
