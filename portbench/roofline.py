"""The yardstick of the scheduler kernels: the card's peaks, and each
kernel's operations and bytes from the shapes of one launch.

Peaks: NVIDIA H100 SXM5 data sheet, dense rates, at the full 700 W power
limit.  The float64 rate is the tensor cores' 67 TFLOP/s (the vector rate
is 34): the larger one, so that a share cannot pass 100% whichever units
a kernel is written for.  Memory: 3.35 TB/s of HBM3.

Counts: each input read once and each output written once, whatever a
kernel reads again; operations are what the algorithm needs for the
launch's inputs, integer and float64 alike, the same whatever implements
the kernel.  A launch's bound is the larger of its operations over the
peak rate and its bytes over the peak bandwidth; a kernel's share of its
roofline is the sum of its launches' bounds over the sum of their device
time.
"""
from __future__ import annotations

PEAK_FLOPS = 67e12        # FP64, tensor cores (H100 SXM5 data sheet)
PEAK_BYTES = 3.35e12      # HBM3 bytes/s (H100 SXM5 data sheet)
WORD = 8                  # every operand is int64 or float64

#: The program's kernel names as the profiler shows them, by launch
#: counter name (K1 and K3 of ``PERF.md``).
KERNEL_NAMES = {"tau": "tau_kernel<false>", "pool": "pool_kernel"}


def _log2(n: int) -> int:
    return max(1, (int(n) - 1).bit_length())


def tau_counts(C: int, J: int, S: int, per_candidate: bool
               ) -> tuple[int, int]:
    """(ops, bytes) of K1 over a [C, J, S] stack.

    Per element of Y: occupied and straddle tests (3), the server's
    straddler count (1), the max into p (1) and the spread count (1).  Per
    job and candidate: Eq. (7) k and f (5), the bandwidth (2), gamma (1),
    exchange (2), reduction (1) and the sum (3).  Bytes: Y and the [J] or
    [C, J] terms G, share, compute in; p, n_srv, tau out."""
    cells = C * J * S
    rows = C * J
    ops = cells * 6 + rows * 14
    terms = rows if per_candidate else J
    nbytes = WORD * (cells + 3 * terms + 3 * rows)
    return ops, nbytes


def pool_counts(B: int, N: int, S: int) -> tuple[int, int]:
    """(ops, bytes) of K3 over B work rows of N GPUs on S servers.

    Per GPU of a row: the charged clock and its two pool tests, the server
    sum and feasible count, the sort key (8); a comparison sort of the row
    by key (2 N ceil(log2 N)); the LBSGF server loads over capacity and
    their sort (S + 2 S ceil(log2 S)).  Bytes: the clocks [B, N], four [B]
    row terms, the [S] offsets and capacities and the [N] server map in;
    the packed [5 B + B N + 2 B S] result out."""
    ops = B * (8 * N + 2 * N * _log2(N) + S + 2 * S * _log2(S))
    nbytes = WORD * ((B * N + 4 * B + 2 * S + N)
                     + (5 * B + B * N + 2 * B * S))
    return ops, nbytes


def bound_s(ops: int, nbytes: int) -> float:
    """The least time the card could take for ``ops`` and ``nbytes``."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def launch_bounds(kernel: str, shapes: list[tuple]) -> float:
    """Summed bound seconds of ``kernel``'s launches, from their shapes as
    :class:`portbench.drive.Probe` records them."""
    total = 0.0
    counts = tau_counts if kernel == "tau" else pool_counts
    for shape in shapes:
        total += bound_s(*counts(*shape))
    return total


def share(rec: dict, kernel: str) -> "float | None":
    """A kernel's share of its roofline over the traced window, in %, or
    None where the window launched it not once or the profiler saw none
    of its launches.  Where the profiler lost some launches, the device
    time a launch is taken over the launches it saw."""
    shapes = rec["shapes"].get(kernel) or []
    seen = rec["kernels"].get(KERNEL_NAMES[kernel])
    if not shapes or not seen or seen[0] == 0 or seen[1] <= 0:
        return None
    count, device_s = seen
    return 100.0 * (launch_bounds(kernel, shapes) / len(shapes)) \
        / (device_s / count)
