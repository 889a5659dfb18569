"""Roofline terms of one step, counted op by op as it runs on DTensors.

The port of ``repro/launch/roofline.py``.  Three terms per (arch, shape,
mesh), in seconds, with the H100 constants of ``launch/mesh.py``:

  compute    = FLOPs per device            / 989e12
  memory     = bytes per device            / 3.35e12
  collective = ICI bytes / 450e9  +  DCN bytes / 50e9

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses collectives out of the partitioned HLO text.  Here one
``TorchDispatchMode``, :class:`CostCounter`, sees every aten op that runs
on each device's local shard (DTensor desugars into them) and every
collective DTensor sends:

* FLOPs: the formulas of ``torch.utils.flop_counter`` (matmuls, bmm,
  convolutions, attention); other ops count no FLOPs, as there.
* bytes: every operand read once plus every output written once, per
  aten op -- XLA's "bytes accessed" with no fusion, so an upper bound on
  what a fused step would move.  Views and allocations move nothing.
* collectives: the output bytes of each ``_c10d_functional`` (and
  DTensor's all-to-all) op, by kind, like ``_OP_RE``.  An op whose group
  spans ranks of more than one pod (``pod_size`` consecutive ranks) is
  the inter-pod (DCN, b^e) share, the rest intra-pod (b^i).

Eager dispatch counts every loop iteration as it runs, so the reference's
HLO parsers that undo XLA's once-per-while-body counting have no
counterpart here, but one: the sLSTM's loop over S positions runs on fake
tensors as one op (``models/slstm_scan.py``), priced as the loop it
stands for -- its FLOPs through ``flop_registry``, its bytes through
:data:`BYTES`, and the memory it holds while it runs through
:data:`WORKSPACE`.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import DCN_BW, HBM_BW, ICI_BW, PEAK_FLOPS_BF16
from repro_torch.models import slstm_scan

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.complex128: 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# collective op name (any namespace below) -> kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")

# ops that read or write no tensor data
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "device", "lift_fresh", "wait_tensor"}

# ops that stand for many (a scan priced as the loop it replaces), beside
# ``flop_registry``: op -> fn(*args, out_val=...) giving the bytes the ops
# it stands for move, and the bytes they hold above its outputs while it
# runs
BYTES = {slstm_scan.scan_op: slstm_scan.scan_bytes,
         slstm_scan.backward_op: slstm_scan.backward_bytes}
WORKSPACE = {slstm_scan.scan_op: slstm_scan.scan_workspace,
             slstm_scan.backward_op: slstm_scan.backward_workspace}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES.get(t.dtype, t.element_size())


def _foreign(tensors, fake_mode) -> bool:
    """Whether any of ``tensors`` is a fake tensor of a mode other than
    ``fake_mode`` (the step's own; None on real tensors)."""
    return any(isinstance(t, FakeTensor) and t.fake_mode is not fake_mode
               for t in tensors)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, float]
    count_by_kind: dict[str, int]     # dynamic counts (every call)
    dcn_bytes: float = 0.0            # pod-crossing share (multi-pod mesh)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    @property
    def ici_bytes(self) -> float:
        return self.total_bytes - self.dcn_bytes

    @property
    def total_count(self) -> int:
        return int(sum(self.count_by_kind.values()))


class CostCounter(TorchDispatchMode):
    """FLOPs, bytes and collectives of the ops run on this device.

    Enter it around one step; DTensor ops are let through to DTensor
    (``NotImplemented``), so the mode sees the local ops and the
    collectives they desugar into.  ``fake_mode`` is the step's own
    ``FakeTensorMode`` (None on real tensors): ops on fake tensors of any
    other mode -- those DTensor's sharding propagation runs at global
    shapes to learn an output's metadata -- are not counted.
    ``pod_size`` > 0 splits the collective bytes into the pod-crossing
    (DCN) share and the rest.
    """

    def __init__(self, pod_size: int = 0, fake_mode=None):
        super().__init__()
        self.pod_size = int(pod_size)
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_by_op: collections.Counter = collections.Counter()
        self.collective_by_op: collections.Counter = collections.Counter()
        self.stats = CollectiveStats({k: 0.0 for k in _COLLECTIVES},
                                     {k: 0 for k in _COLLECTIVES})
        self._crosses: dict[str, bool] = {}

    def _crosses_pod(self, group_name: str) -> bool:
        """Does the group named ``group_name`` hold ranks of more than one
        pod?  Pod p owns ranks [p*pod_size, (p+1)*pod_size): the
        counterpart of the reference's replica-group test."""
        if group_name not in self._crosses:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
            self._crosses[group_name] = len(
                {r // self.pod_size for r in ranks}) > 1
        return self._crosses[group_name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if _foreign(outs, self.fake_mode):
            return out                       # sharding propagation
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NS and name in _KIND:
            kind = _KIND[name]
            b = float(sum(_nbytes(t) for t in outs))
            self.stats.bytes_by_kind[kind] += b
            self.stats.count_by_kind[kind] += 1
            self.collective_by_op[f"{kind} {list(outs[0].shape)} "
                                  f"{outs[0].dtype}"] += b
            if self.pod_size:
                group = [a for a in tuple(args) + tuple(kwargs.values())
                         if isinstance(a, str)][-1]
                if self._crosses_pod(group):
                    self.stats.dcn_bytes += b
            return out
        if func.namespace in _COLLECTIVE_NS or name in _NO_TRAFFIC \
                or func.is_view:
            return out
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        if func in BYTES:
            b = float(BYTES[func](*args, **kwargs, out_val=out))
        else:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            b = float(sum(_nbytes(t) for t in ins + outs))
        self.bytes += b
        self.bytes_by_op[str(func._overloadpacket)] += b
        return out


def bytes_breakdown(counter: CostCounter, top: int = 15) -> list[dict]:
    """The largest HBM-traffic contributors, by aten op."""
    return [{"op": op, "bytes": b}
            for op, b in counter.bytes_by_op.most_common(top)]


def collective_breakdown(counter: CostCounter, top: int = 12) -> list[dict]:
    """The largest collective contributions, by kind, shape and dtype."""
    return [{"op": op, "bytes": b}
            for op, b in counter.collective_by_op.most_common(top)]


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # PER-DEVICE FLOPs (counted on the local
                                  # shards; == global/chips when even)
    hlo_bytes: float              # per-device HBM traffic
    collective_bytes: float       # per-device fabric traffic
    collectives: CollectiveStats
    model_flops: float            # 6*N*D (or 6*N_active*D) per step, GLOBAL
    per_device_hbm_peak: float    # bytes

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        dcn = self.collectives.dcn_bytes if self.collectives else 0.0
        ici = self.collective_bytes - dcn
        return ici / ICI_BW + dcn / DCN_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs -- remat/redundancy waste detector."""
        return self.model_flops / max(self.hlo_flops * self.chips, 1.0)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "hbm_peak_bytes": self.per_device_hbm_peak,
        }


def local_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a step's argument tree (nested dicts, lists, tuples
    and dataclasses such as ``KVCache``) on this device: a DTensor's
    local shard."""
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for node in tree for t in local_tensors(node)]


def local_bytes(tree) -> float:
    """Bytes of the tensors of ``tree`` on this device."""
    return float(sum(_nbytes(t) for t in local_tensors(tree)))


class PeakMemory(TorchDispatchMode):
    """The peak bytes of the storages a step's ops create on this device,
    each counted from the op that makes it until it is freed (on a CUDA
    device rounded up to the allocator's 512-byte blocks, as
    ``MemTracker`` does).

    ``held`` are storages that exist before the step (its arguments):
    views of them are not counted again.  Ops on fake tensors of a mode
    other than ``fake_mode`` (DTensor's sharding propagation at global
    shapes) are skipped, as in :class:`CostCounter`: the filter keys on
    the tensors' own mode, so it holds whether or not a fake mode is
    active while the step runs."""

    def __init__(self, held=(), fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.current = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in held:
            self._seen[t.untyped_storage()] = None

    def _free(self, n: int, _ref) -> None:
        self.current -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if _foreign(outs, self.fake_mode):
            return out
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            if t.device.type == "cuda":
                n = -(-n // 512) * 512
            self._seen[st] = weakref.ref(st, functools.partial(self._free, n))
            self.current += n
            self.peak = max(self.peak, self.current)
        if func in WORKSPACE:
            self.peak = max(self.peak, self.current + WORKSPACE[func](
                *args, **(kwargs or {}), out_val=out))
        return out


def memory_peak(fn, args, *, fake_mode=None) -> tuple:
    """Run ``fn(*args)``; return (its output, the per-device peak bytes):
    the arguments' bytes on this device plus the peak above them.

    On fake tensors of ``fake_mode`` the peak above comes from
    :class:`PeakMemory`; on real tensors (``fake_mode`` None, on the
    card) it is ``max_memory_allocated`` above what was allocated when
    the step began.  Tensors made before the step other than its
    arguments are not counted (the caller's, not the step's)."""
    args_bytes = local_bytes(args)
    if fake_mode is None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, args_bytes + torch.cuda.max_memory_allocated() - base
    tracker = PeakMemory(local_tensors(args), fake_mode)
    with tracker:
        out = fn(*args)
    return out, args_bytes + tracker.peak


def model_step_flops(cfg, shape) -> float:
    """6*N*D for a train step (fwd 2ND + bwd 4ND); 2*N*D for pure forward
    (prefill); 2*N_active per generated token for decode."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: one token each
