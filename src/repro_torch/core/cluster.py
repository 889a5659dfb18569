"""Cluster model for RAR-DDLS (paper §4.1), with optional heterogeneity.

A multi-tenant GPU cluster: a set of servers ``s ∈ S``, each with GPU
capacity ``O_s``; fast intra-server interconnect bandwidth ``b_i`` (NVLink
class) and slow, contended inter-server bandwidth ``b_e`` (Ethernet class),
with ``b_i >> b_e``.  The paper assumes homogeneous GPUs with compute speed
``C`` (amount of gradient data reduced per time-slot) and a single shared
``b_e``; this module generalises both while keeping the homogeneous case
bit-identical:

  * ``gpu_speeds`` -- optional per-GPU compute speeds.  A ring is paced by
    its slowest member (Eq. (1) evaluates at the minimum ``C`` over the
    job's GPUs), so engines only ever need the per-server *speed floor*
    (slowest GPU on each server) and derive a job's effective speed from
    its occupancy row ``y_j``.
  * ``links`` -- optional per-server uplink classes ``(bandwidth, kind)``
    with ``kind in {"shared", "isolated"}``.  Shared uplinks contend and
    pay the Eq. (8) divisor ``f(alpha, k)``; isolated uplinks (private
    paths, arXiv:2308.05692) deliver their full bandwidth.  A straddling
    job's inter-server bandwidth is the worst over its occupied servers:
    ``min(min_iso_bw, min_shared_bw / f)``.

The contention-model constants (paper Eqs. 6-8):
  * ``xi1``  -- fraction of wall time a job actually contends (Eq. 7)
  * ``xi2``  -- per-server communication-overhead coefficient (gamma)
  * ``alpha`` -- bandwidth-sharing degradation slope, f(a,k) = k + a(k-1)
"""
from __future__ import annotations

import dataclasses
import functools
import numbers
from typing import Any, Sequence

import numpy as np

LINK_KINDS = ("shared", "isolated")


@dataclasses.dataclass(frozen=True)
class Cluster:
    """Static description of the multi-tenant GPU cluster.

    ``gpu_speed``/``b_inter`` remain the uniform defaults; ``gpu_speeds``
    (one entry per GPU) and ``links`` (one ``(bandwidth, kind)`` uplink per
    server) override them per-device.  ``b_intra`` stays a global scalar:
    intra-server fabrics are uncontended in the model and a single-server
    ring never crosses an uplink.
    """

    capacities: tuple[int, ...]      # O_s, GPUs per server
    b_intra: float = 300.0           # b^i, intra-server link bandwidth (GB/slot)
    b_inter: float = 1.25            # b^e, inter-server link bandwidth (GB/slot)
    gpu_speed: float = 50.0          # C, reduction throughput (GB/slot)
    xi1: float = 0.7                 # Eq. (7) contention duty-cycle
    xi2: float = 0.002               # gamma coefficient (slots per server spanned)
    alpha: float = 0.3               # degradation slope in f(alpha, k)
    gpu_speeds: tuple[float, ...] | None = None   # per-GPU C, len == num_gpus
    links: tuple[tuple[float, str], ...] | None = None  # per-server (bw, kind)

    def __post_init__(self) -> None:
        if not self.capacities:
            raise ValueError("cluster needs at least one server")
        if any(c <= 0 for c in self.capacities):
            raise ValueError("server capacities must be positive")
        for name in ("b_intra", "b_inter", "gpu_speed"):
            val = getattr(self, name)
            if not isinstance(val, numbers.Real):
                raise ValueError(
                    f"Cluster.{name} is the uniform scalar (got {type(val).__name__}); "
                    "per-device values go in 'gpu_speeds' (per GPU) or 'links' "
                    "(per server)"
                )
        if self.b_intra < self.b_inter:
            raise ValueError("paper assumes b_intra >> b_inter")
        if self.gpu_speeds is not None:
            if isinstance(self.gpu_speeds, numbers.Real):
                raise ValueError(
                    "Cluster.gpu_speeds is per-GPU (one entry per GPU); a single "
                    "uniform speed goes in the scalar 'gpu_speed' field"
                )
            speeds = tuple(float(v) for v in self.gpu_speeds)
            object.__setattr__(self, "gpu_speeds", speeds)
            if len(speeds) != self.num_gpus:
                raise ValueError(
                    f"Cluster.gpu_speeds has {len(speeds)} entries but the cluster "
                    f"has {self.num_gpus} GPUs (one speed per GPU)"
                )
            if any(v <= 0 for v in speeds):
                raise ValueError("Cluster.gpu_speeds entries must be positive")
        if self.links is not None:
            links = []
            for i, link in enumerate(self.links):
                try:
                    bw, kind = link
                except (TypeError, ValueError):
                    raise ValueError(
                        f"Cluster.links[{i}] must be a (bandwidth, kind) pair, "
                        f"got {link!r}"
                    ) from None
                if kind not in LINK_KINDS:
                    raise ValueError(
                        f"Cluster.links[{i}] kind must be one of {LINK_KINDS}, "
                        f"got {kind!r}"
                    )
                bw = float(bw)
                if bw <= 0:
                    raise ValueError(f"Cluster.links[{i}] bandwidth must be positive")
                if self.b_intra < bw:
                    raise ValueError(
                        f"Cluster.links[{i}] uplink bandwidth {bw} exceeds b_intra "
                        f"{self.b_intra}; the paper assumes b_intra >> uplink"
                    )
                links.append((bw, kind))
            object.__setattr__(self, "links", tuple(links))
            if len(links) != self.num_servers:
                raise ValueError(
                    f"Cluster.links has {len(links)} entries but the cluster has "
                    f"{self.num_servers} servers (one uplink per server)"
                )

    # ---- derived quantities -------------------------------------------------

    @functools.cached_property
    def num_servers(self) -> int:
        """Number of servers S."""
        return len(self.capacities)

    @functools.cached_property
    def num_gpus(self) -> int:
        """Total GPU count N = sum of the capacities."""
        return int(sum(self.capacities))

    # The derived arrays below are cached per instance (the scheduler and
    # simulator read them in every placement probe / event window).  The
    # dataclass is frozen, so the fields they derive from never change;
    # ``functools.cached_property`` writes straight to ``__dict__`` and
    # therefore works on frozen dataclasses.  Treat them as read-only.

    @functools.cached_property
    def capacities_array(self) -> np.ndarray:
        """Per-server GPU counts as an int64 array, shape [S]."""
        return np.asarray(self.capacities, dtype=np.int64)

    @functools.cached_property
    def gpu_server(self) -> np.ndarray:
        """Map global GPU id -> server id, shape [N]."""
        return np.repeat(np.arange(self.num_servers), self.capacities_array)

    @functools.cached_property
    def is_heterogeneous(self) -> bool:
        """True when any per-device value differs from the uniform scalars.

        Uniform arrays that merely restate ``gpu_speed``/``(b_inter,
        "shared")`` keep the fast scalar paths; uniform arrays at *other*
        values are heterogeneous (the scalar fields would price them wrong).
        """
        if self.gpu_speeds is not None and any(
            v != self.gpu_speed for v in self.gpu_speeds
        ):
            return True
        if self.links is not None and any(
            bw != self.b_inter or kind != "shared" for bw, kind in self.links
        ):
            return True
        return False

    @functools.cached_property
    def gpu_speeds_array(self) -> np.ndarray:
        """Per-GPU compute speed C, shape [N] (uniform fallback)."""
        if self.gpu_speeds is None:
            return np.full(self.num_gpus, float(self.gpu_speed))
        return np.asarray(self.gpu_speeds, dtype=np.float64)

    @functools.cached_property
    def server_speed_floor(self) -> np.ndarray:
        """Slowest GPU speed on each server, shape [S].

        Eq. (1) evaluates a ring at its slowest member; GPU assignment
        within a server is fungible, so the engines price a job at
        ``min(server_speed_floor[occupied servers])``.
        """
        return np.minimum.reduceat(
            self.gpu_speeds_array,
            np.concatenate([[0], np.cumsum(self.capacities_array)[:-1]]),
        )

    @functools.cached_property
    def uplink_bandwidth(self) -> np.ndarray:
        """Per-server uplink bandwidth, shape [S] (uniform b_inter fallback)."""
        if self.links is None:
            return np.full(self.num_servers, float(self.b_inter))
        return np.asarray([bw for bw, _ in self.links], dtype=np.float64)

    @functools.cached_property
    def uplink_isolated(self) -> np.ndarray:
        """Per-server bool: True when the uplink skips the f(alpha,k) divisor."""
        if self.links is None:
            return np.zeros(self.num_servers, dtype=bool)
        return np.asarray([kind == "isolated" for _, kind in self.links])

    @functools.cached_property
    def uplink_shared_or_inf(self) -> np.ndarray:
        """Shared-uplink bandwidth per server, +inf where isolated, shape [S]."""
        return np.where(self.uplink_isolated, np.inf, self.uplink_bandwidth)

    @functools.cached_property
    def uplink_isolated_or_inf(self) -> np.ndarray:
        """Isolated-uplink bandwidth per server, +inf where shared, shape [S]."""
        return np.where(self.uplink_isolated, self.uplink_bandwidth, np.inf)

    @functools.cached_property
    def _batch_key_cache(self) -> dict:
        """Scratch for :func:`repro_torch.core.columnar.server_sums`: rows ->
        read-only flattened ``row * S + gpu_server`` bincount keys.  Purely
        derived from frozen fields, so caching on the instance is safe for
        the same reason as the properties above."""
        return {}

    def server_gpu_ids(self, s: int) -> np.ndarray:
        """Global GPU ids living on server ``s``."""
        offsets = np.concatenate([[0], np.cumsum(self.capacities_array)])
        return np.arange(offsets[s], offsets[s + 1])

    def placement_matrix(self, gpu_sets: Sequence[np.ndarray]) -> np.ndarray:
        """Build the Y matrix [J, S]: #GPUs of each job on each server."""
        srv = self.gpu_server
        out = np.zeros((len(gpu_sets), self.num_servers), dtype=np.int64)
        for j, gpus in enumerate(gpu_sets):
            if len(gpus) == 0:
                continue
            np.add.at(out[j], srv[np.asarray(gpus, dtype=np.int64)], 1)
        return out

    # ---- journal round-trip -------------------------------------------------

    def to_payload(self) -> dict[str, Any]:
        """JSON-safe description (``from_payload`` round-trips exactly)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "Cluster":
        """Rebuild from :meth:`to_payload` output (JSON lists -> tuples)."""
        data = dict(payload)
        data["capacities"] = tuple(int(c) for c in data["capacities"])
        if data.get("gpu_speeds") is not None:
            data["gpu_speeds"] = tuple(float(v) for v in data["gpu_speeds"])
        if data.get("links") is not None:
            data["links"] = tuple(
                (float(bw), str(kind)) for bw, kind in data["links"]
            )
        return cls(**data)


def _draw_hetero(
    rng: np.random.Generator,
    capacities: tuple[int, ...],
    speed_tiers: Sequence[tuple[float, float]] | None,
    link_classes: Sequence[tuple[float, str, float]] | None,
) -> dict[str, Any]:
    """Per-server tier draws shared by ``philly_cluster`` and ``ClusterSpec``.

    ``speed_tiers`` is ``((speed, weight), ...)``: each server draws one
    tier and all its GPUs inherit it (servers are internally homogeneous,
    matching real multi-generation fleets).  ``link_classes`` is
    ``((bandwidth, kind, weight), ...)`` drawn per server uplink.
    """
    kwargs: dict[str, Any] = {}
    if speed_tiers:
        speeds = np.asarray([s for s, _ in speed_tiers], dtype=np.float64)
        w = np.asarray([w for _, w in speed_tiers], dtype=np.float64)
        pick = rng.choice(len(speeds), size=len(capacities), p=w / w.sum())
        kwargs["gpu_speeds"] = tuple(
            float(speeds[t]) for t, cap in zip(pick, capacities) for _ in range(cap)
        )
    if link_classes:
        w = np.asarray([w for _, _, w in link_classes], dtype=np.float64)
        pick = rng.choice(len(link_classes), size=len(capacities), p=w / w.sum())
        kwargs["links"] = tuple(
            (float(link_classes[t][0]), str(link_classes[t][1])) for t in pick
        )
    return kwargs


def philly_cluster(
    num_servers: int = 20,
    seed: int = 0,
    speed_tiers: Sequence[tuple[float, float]] | None = None,
    link_classes: Sequence[tuple[float, str, float]] | None = None,
) -> Cluster:
    """The §7 experiment cluster: ``num_servers`` servers, O_s ~ U{4,8,16,32}.

    Optional ``speed_tiers``/``link_classes`` add per-server heterogeneity
    draws (see :func:`_draw_hetero`); the default draw consumes the RNG
    identically to the homogeneous original, so existing seeds reproduce
    bit-identical clusters.
    """
    rng = np.random.default_rng(seed)
    caps = tuple(int(c) for c in rng.choice([4, 8, 16, 32], size=num_servers))
    return Cluster(capacities=caps, **_draw_hetero(rng, caps, speed_tiers, link_classes))
