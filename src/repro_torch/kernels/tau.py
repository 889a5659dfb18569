"""Eq. (6)-(8) candidate-stack reduction: CUDA kernels and plain versions.

The port of ``repro/kernels/tau.py`` (TPU kernels ``_tau_kernel`` and
``_tau_kernel_het``).  The contention model scores stacks of candidate
placements Y [C, J, S]: per candidate the straddle matrix (Eq. 6), the
per-server straddler counts, each job's contention level p, its server
spread n_srv and the per-iteration RAR time tau (Eq. 8).
``csrc/tau.cu`` runs one CUDA block per candidate (see the note there).

Two wrappers, one per kernel, take torch tensors: :func:`tau_stack_hom`
(homogeneous cluster, launches counted as ``"tau"``) and
:func:`tau_stack_het` (per-server speed floors and shared/isolated
uplinks, counted as ``"tau_het"``).  A CPU tensor runs the plain PyTorch
version beside each (:func:`tau_stack_hom_plain`,
:func:`tau_stack_het_plain`), which is float64 in the same operation
order as the NumPy engines.

:func:`tau_stack` is the NumPy-in/NumPy-out entry point
``contention.stack_model`` calls.  On the card it packs its inputs into
one pinned host buffer (layout in :func:`tau_words`) and makes one C call
(``tau_step_hom`` / ``tau_step_het`` in ``csrc/tau.cu``): one copy up, one
launch, one copy back into another pinned buffer and one wait.  The
buffers are kept per device and grown as needed (:class:`_Staging`); the
results are copies, never views of them.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.kernels import LAUNCHES, _build

__all__ = ["tau_stack", "tau_stack_hom", "tau_stack_het",
           "tau_stack_hom_plain", "tau_stack_het_plain"]

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "tau_stack_hom": [_P] * 7 + [_I, _I, _I, _L] + [_D] * 6 + [_P],
    "tau_stack_het": [_P] * 10 + [_I, _I, _I, _L] + [_D] * 4 + [_P],
    "tau_step_hom": [_P, _P] + [_L] * 4 + [_P, _P, _I, _I, _I, _L]
    + [_D] * 6 + [_P],
    "tau_step_het": [_P, _P] + [_L] * 4 + [_P] * 5 + [_I, _I, _I, _L]
    + [_D] * 4 + [_P],
}


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a tensor shaped like ``like``.  Dividing by (or into) a
    Python scalar is not an IEEE division in PyTorch (``x / c`` on CUDA
    and ``c / x`` everywhere multiply by a reciprocal), so every division
    here is tensor by tensor."""
    return torch.full_like(like, value)


def _straddle_counts(Y: torch.Tensor, G: torch.Tensor):
    """Eq. (6) per candidate: (occupied mask, p, n_srv), integer-exact."""
    C, J, _ = Y.shape
    G2 = G.expand(C, J)
    pos = Y > 0
    straddle = pos & (Y < G2[:, :, None])
    per_server = straddle.sum(dim=1)                       # [C, S]
    p = torch.where(straddle, per_server[:, None, :], 0).amax(dim=2)
    return pos, p, pos.sum(dim=2)


def _degradation(p: torch.Tensor, xi1: float, alpha: float) -> torch.Tensor:
    """Eq. (7) k = max(xi1 * p, 1) and f(alpha, k) = k + alpha * (k - 1)."""
    k = torch.clamp(xi1 * p.to(torch.float64), min=1.0)
    return k + alpha * (k - 1.0)


def tau_stack_hom_plain(Y, G, share, compute, *, xi1, xi2, alpha, b_inter,
                        b_intra, gpu_speed):
    """Plain PyTorch version of the homogeneous kernel (K1)."""
    _, p, n_srv = _straddle_counts(Y, G)
    f = _degradation(p, xi1, alpha)
    bandwidth = torch.where(n_srv > 1, _full(b_inter, f) / f, b_intra)
    share2 = share.expand(p.shape)
    gamma = xi2 * n_srv.to(torch.float64)
    exchange = (2.0 * share2) / bandwidth
    reduce_t = share2 / _full(gpu_speed, share2)
    tau = exchange + reduce_t + gamma + compute.expand(p.shape)
    return p, n_srv, tau


def tau_stack_het_plain(Y, G, share, compute, speed_floor, uplink_sh,
                        uplink_iso, *, xi1, xi2, alpha, b_intra):
    """Plain PyTorch version of the heterogeneous kernel (K2): the masked
    minima over each row's occupied servers are pure selections."""
    pos, p, n_srv = _straddle_counts(Y, G)
    inf = float("inf")
    speed = torch.where(pos, speed_floor, inf).amin(dim=2)
    bw_sh = torch.where(pos, uplink_sh, inf).amin(dim=2)
    bw_iso = torch.where(pos, uplink_iso, inf).amin(dim=2)
    f = _degradation(p, xi1, alpha)
    bandwidth = torch.where(n_srv > 1, torch.minimum(bw_iso, bw_sh / f),
                            b_intra)
    share2 = share.expand(p.shape)
    gamma = xi2 * n_srv.to(torch.float64)
    exchange = (2.0 * share2) / bandwidth
    tau = exchange + share2 / speed + gamma + compute.expand(p.shape)
    return p, n_srv, tau


def _check_stack(Y, G, share, compute):
    """Shapes of a stack and its [J] or [C, J] terms; returns (C, J, S,
    term_stride)."""
    if Y.dim() != 3:
        raise ValueError(f"Y must be [C, J, S], got {tuple(Y.shape)}")
    C, J, S = Y.shape
    _build.check(Y, "Y", torch.int64, (C, J, S), Y.device)
    if G.dim() not in (1, 2):
        raise ValueError(f"G must be [J] or [C, J], got {tuple(G.shape)}")
    terms = (J,) if G.dim() == 1 else (C, J)
    _build.check(G, "G", torch.int64, terms, Y.device)
    _build.check(share, "share", torch.float64, terms, Y.device)
    _build.check(compute, "compute", torch.float64, terms, Y.device)
    return C, J, S, (J if G.dim() == 2 else 0)


def _outputs(C: int, J: int, device):
    return (torch.empty((C, J), dtype=torch.int64, device=device),
            torch.empty((C, J), dtype=torch.int64, device=device),
            torch.empty((C, J), dtype=torch.float64, device=device))


def tau_stack_hom(Y, G, share, compute, *, xi1, xi2, alpha, b_inter, b_intra,
                  gpu_speed):
    """K1 wrapper: ``(p, n_srv, tau)`` [C, J] of a homogeneous stack.

    ``Y`` [C, J, S] int64; ``G`` int64 and ``share``/``compute`` float64,
    each [J] (shared across the stack) or [C, J] (per candidate)."""
    C, J, S, stride = _check_stack(Y, G, share, compute)
    if Y.device.type == "cpu":
        return tau_stack_hom_plain(Y, G, share, compute, xi1=xi1, xi2=xi2,
                                   alpha=alpha, b_inter=b_inter,
                                   b_intra=b_intra, gpu_speed=gpu_speed)
    p, n_srv, tau = _outputs(C, J, Y.device)
    if C and J:
        _build.launch("tau", _SIGNATURES, "tau_stack_hom", Y.device,
                      Y.data_ptr(), G.data_ptr(), share.data_ptr(),
                      compute.data_ptr(), p.data_ptr(), n_srv.data_ptr(),
                      tau.data_ptr(), C, J, S, stride, xi1, xi2, alpha,
                      b_inter, b_intra, gpu_speed)
        LAUNCHES["tau"] += 1
    return p, n_srv, tau


def tau_stack_het(Y, G, share, compute, speed_floor, uplink_sh, uplink_iso,
                  *, xi1, xi2, alpha, b_intra):
    """K2 wrapper: ``(p, n_srv, tau)`` [C, J] of a heterogeneous stack.

    As :func:`tau_stack_hom`, plus the cluster's per-server speed floors
    and shared/isolated uplink bandwidths, each float64 [S] (+inf where
    the class is absent)."""
    C, J, S, stride = _check_stack(Y, G, share, compute)
    for name, t in (("speed_floor", speed_floor), ("uplink_sh", uplink_sh),
                    ("uplink_iso", uplink_iso)):
        _build.check(t, name, torch.float64, (S,), Y.device)
    if Y.device.type == "cpu":
        return tau_stack_het_plain(Y, G, share, compute, speed_floor,
                                   uplink_sh, uplink_iso, xi1=xi1, xi2=xi2,
                                   alpha=alpha, b_intra=b_intra)
    p, n_srv, tau = _outputs(C, J, Y.device)
    if C and J:
        _build.launch("tau", _SIGNATURES, "tau_stack_het", Y.device,
                      Y.data_ptr(), G.data_ptr(), share.data_ptr(),
                      compute.data_ptr(), speed_floor.data_ptr(),
                      uplink_sh.data_ptr(), uplink_iso.data_ptr(),
                      p.data_ptr(), n_srv.data_ptr(), tau.data_ptr(), C, J,
                      S, stride, xi1, xi2, alpha, b_intra)
        LAUNCHES["tau_het"] += 1
    return p, n_srv, tau


@functools.lru_cache(maxsize=64)
def cluster_tensors(cluster, device: torch.device) -> dict:
    """Per-(cluster, device) constant tensors the kernels read: the
    per-server speed floors and shared/isolated uplinks (+inf where
    absent), float64 [S], and each server's first GPU id and capacity,
    int64 [S] (servers own contiguous GPU-id ranges)."""
    caps = np.asarray(cluster.capacities_array, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)

    def put(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return {
        "speed_floor": put(cluster.server_speed_floor, torch.float64),
        "uplink_sh": put(cluster.uplink_shared_or_inf, torch.float64),
        "uplink_iso": put(cluster.uplink_isolated_or_inf, torch.float64),
        "offsets": put(offsets, torch.int64),
        "caps": put(caps, torch.int64),
    }


def to_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A contiguous copy of the NumPy array ``a`` on ``device``."""
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# NumPy-in / NumPy-out entry point
# --------------------------------------------------------------------------


def tau_words(C: int, J: int, S: int, terms_2d: bool
              ) -> tuple[int, int, int, int]:
    """``(g, share, compute, words)``: the int64-word offsets of G, share
    and compute in :func:`tau_stack`'s packed input, and its length.

    Y [C, J, S] int64 fills words 0 to C*J*S; G (int64), share and compute
    (float64 bits) follow, each [C, J] with ``terms_2d``, else [J], and
    each from an even word (16 bytes)."""
    T = C * J if terms_2d else J
    g = C * J * S
    g += g & 1
    sh = g + T + ((g + T) & 1)
    cp = sh + T + ((sh + T) & 1)
    return g, sh, cp, cp + T


def pack_stack(words: np.ndarray, Y: np.ndarray, G: np.ndarray,
               share: np.ndarray, compute: np.ndarray) -> int:
    """Write a stack and its terms into the int64 array ``words`` at the
    offsets of :func:`tau_words`; returns the words written."""
    g, sh, cp, n = tau_words(*Y.shape, G.ndim == 2)
    T = G.size
    words[:Y.size].reshape(Y.shape)[...] = Y
    words[g:g + T].reshape(G.shape)[...] = G
    f = words.view(np.float64)
    f[sh:sh + T].reshape(G.shape)[...] = share
    f[cp:cp + T].reshape(G.shape)[...] = compute
    return n


class _Staging:
    """Per-device state of :func:`tau_stack`: a pinned host buffer and a
    device buffer of int64 words in each direction (``inp``, ``out``: each
    ``(host tensor, its NumPy view, device tensor, host pointer, device
    pointer)``), grown (doubled) as needed and never shrunk.  A call
    reuses them only after the wait that ended the previous call, and
    copies its results out of them.  Host buffers are pinned on a CUDA
    device only (a CPU-only build of torch cannot pin)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.inp = self.out = None

    def _grow(self, have, words: int):
        n = max(words, 2 * have[0].numel() if have else 0, 1)
        host = torch.empty(n, dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")
        dev = torch.empty(n, dtype=torch.int64, device=self.device)
        return host, host.numpy(), dev, host.data_ptr(), dev.data_ptr()

    def reserve(self, n_in: int, n_out: int):
        """``(inp, out)`` of at least ``n_in`` and ``n_out`` words.  A call
        that grows either adds one to the ``tau.regrows`` counter."""
        inp, out = self.inp, self.out
        if inp is None or inp[0].numel() < n_in or out[0].numel() < n_out:
            if inp is None or inp[0].numel() < n_in:
                inp = self.inp = self._grow(inp, n_in)
            if out is None or out[0].numel() < n_out:
                out = self.out = self._grow(out, n_out)
            if obs.on:
                obs.COUNTERS["tau.regrows"] += 1
        return inp, out


@functools.lru_cache(maxsize=16)
def _staging(index: int) -> _Staging:
    """The staging of CUDA device ``index``, shared by every cluster."""
    return _Staging(torch.device("cuda", index))


def _current() -> tuple[int, int]:
    """The current CUDA device's index and the handle of its current
    stream, looked up without making a ``torch.cuda.Stream``."""
    index = torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


@functools.cache
def _step_fn(name: str):
    """The ctypes function of the C entry point ``name`` (built and bound
    on first use)."""
    return getattr(_build.load("tau", _SIGNATURES), name)


def _check_arrays(Y, G, share, compute) -> None:
    """Raise unless ``Y`` is an integer [C, J, S] array and ``G`` (integer),
    ``share`` and ``compute`` (floating) are [J] or [C, J] arrays."""
    if Y.ndim != 3 or Y.dtype.kind not in "iu":
        raise ValueError(f"Y must be an integer [C, J, S] array, got "
                         f"{Y.dtype} {Y.shape}")
    C, J, _ = Y.shape
    if G.shape not in ((J,), (C, J)) or G.dtype.kind not in "iu":
        raise ValueError(f"G must be an integer [J] or [C, J] array, got "
                         f"{G.dtype} {G.shape}")
    for name, a in (("share", share), ("compute", compute)):
        if a.shape != G.shape or a.dtype.kind != "f":
            raise ValueError(f"{name} must be a float {G.shape} array, got "
                             f"{a.dtype} {a.shape}")


def _round_trip(cluster, G, share, compute, Y, on):
    """:func:`tau_stack` of a non-empty stack on the current CUDA device:
    pack, one C call, copy out."""
    C, J, S = Y.shape
    if on:
        sub = obs.open_span("tau_stack.h2d")
    index, stream = _current()
    st = _staging(index)
    g, sh, cp, n_in = tau_words(C, J, S, G.ndim == 2)
    CJ = C * J
    inp, out = st.reserve(n_in, 3 * CJ)
    pack_stack(inp[1], Y, G, share, compute)
    if on:
        obs.close_span(sub)
        sub = obs.open_span("tau_stack.launch")
    head = (inp[3], inp[4], n_in, g, sh, cp)
    tail = (C, J, S, J if G.ndim == 2 else 0, float(cluster.xi1),
            float(cluster.xi2), float(cluster.alpha))
    if cluster.is_heterogeneous:
        ct = cluster_tensors(cluster, st.device)
        name, fn = "tau_het", _step_fn("tau_step_het")
        args = (*head, ct["speed_floor"].data_ptr(),
                ct["uplink_sh"].data_ptr(), ct["uplink_iso"].data_ptr(),
                out[4], out[3], *tail, float(cluster.b_intra), stream)
    else:
        name, fn = "tau", _step_fn("tau_step_hom")
        args = (*head, out[4], out[3], *tail, float(cluster.b_inter),
                float(cluster.b_intra), float(cluster.gpu_speed), stream)
    err = fn(*args)
    if err:
        msg = _step_fn("tau_error_string")(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} (error {err})")
    LAUNCHES[name] += 1
    if on:
        obs.close_span(sub)
        sub = obs.open_span("tau_stack.d2h")
    res = out[1][:3 * CJ].copy()
    if on:
        obs.close_span(sub)
    return (res[:CJ].reshape(C, J), res[CJ:2 * CJ].reshape(C, J),
            res[2 * CJ:].view(np.float64).reshape(C, J))


def tau_stack(cluster, G: np.ndarray, share: np.ndarray,
              compute: np.ndarray, Y: np.ndarray, device="cuda"
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kernel-backed Eq. (6)-(8) stack reduction: (p, n_srv, tau), [C, J].

    ``Y`` [C, J, S] is the (already masked) candidate stack; ``G``,
    ``share`` and ``compute`` are the placement-independent per-job terms
    (see ``repro_torch.core.contention._job_terms``), either shared
    across the stack ([J]) or per candidate ([C, J]).  Returns NumPy
    int64/int64/float64.  On the card: one copy up, one launch of K1 (K2
    on a heterogeneous cluster), one copy back, one wait.  On the CPU the
    homogeneous or heterogeneous wrapper runs its plain version."""
    on = obs.on
    if on:
        top = obs.open_span("kernel.tau_stack")
        obs.COUNTERS["tau.rows"] += Y.shape[0] * Y.shape[1]
    dev = resolve_device(device)
    _check_arrays(Y, G, share, compute)
    C, J = Y.shape[:2]
    if dev.type == "cuda":
        if not (C and J):
            out = (np.zeros((C, J), dtype=np.int64),
                   np.zeros((C, J), dtype=np.int64),
                   np.zeros((C, J), dtype=np.float64))
        elif dev.index is None or dev.index == torch.cuda.current_device():
            out = _round_trip(cluster, G, share, compute, Y, on)
        else:
            with torch.cuda.device(dev):
                out = _round_trip(cluster, G, share, compute, Y, on)
        if on:
            obs.close_span(top)
        return out
    if on:
        sub = obs.open_span("tau_stack.h2d")
    args = (to_device(Y, torch.int64, dev), to_device(G, torch.int64, dev),
            to_device(share, torch.float64, dev),
            to_device(compute, torch.float64, dev))
    if on:
        obs.close_span(sub)
        sub = obs.open_span("tau_stack.launch")
    scal = dict(xi1=float(cluster.xi1), xi2=float(cluster.xi2),
                alpha=float(cluster.alpha), b_intra=float(cluster.b_intra))
    if cluster.is_heterogeneous:
        ct = cluster_tensors(cluster, dev)
        p, n_srv, tau = tau_stack_het(*args, ct["speed_floor"],
                                      ct["uplink_sh"], ct["uplink_iso"],
                                      **scal)
    else:
        p, n_srv, tau = tau_stack_hom(*args, b_inter=float(cluster.b_inter),
                                      gpu_speed=float(cluster.gpu_speed),
                                      **scal)
    if on:
        obs.close_span(sub)
        sub = obs.open_span("tau_stack.d2h")
    out = p.numpy(), n_srv.numpy(), tau.numpy()
    if on:
        obs.close_span(top)
    return out
