"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics the cell reports.

A cell is found by its name in ``BENCHMARK.json``; its configuration by
name under ``configs/``, its traffic mix under ``traffic/`` and each of
its metrics' readers under ``metrics/`` (``metrics/<name>.py``, or
``metrics/<base>.py`` for the part of the name before its first dot;
``read(record)`` returns the number, or None where the run gave it
nothing to read).  Adding a cell or a metric adds files and entries; it
edits nothing here.

A traffic mix has ``inputs`` inputs, each its own cluster and jobs, and
the window is whole cycles over them.  Two kinds:

  * ``backlog`` -- each input all there at slot 0, scheduled and
    simulated (``params`` go to the policy);
  * ``stream`` -- each input's jobs submitted at their arrival slots to a
    fresh scheduler service, then drained.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

from portbench import check, gen, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that no run may have loaded: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(man: dict, name: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of the cell ``name``."""
    for w in man["workloads"]:
        if w["name"] == name:
            return (w, gen.load_json("configs", w["config"]),
                    gen.load_json("traffic", w["traffic"]))
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def metrics_for(man: dict, name: str, trace: bool) -> list[dict]:
    """The metrics the cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced."""
    if not trace:
        return [m for m in man["end_to_end"]
                if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in man["end_to_end"]
           if name in m.get("workloads", [name])}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e
                             else [])]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``, or else of
    ``metrics/<base>.py``, ``base`` being the name up to its first dot."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Forbidden top-level modules loaded in this process, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(workload: dict, config: dict, traffic: dict, seed: int,
        seconds: float, trace: bool, metrics: list[dict],
        device="cuda", t_start: "float | None" = None) -> dict:
    """One run; returns the result line's fields plus ``lines``, the
    comparisons to print last on standard error.  ``t_start`` is when the
    process began its set-up (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from portbench import devtrace, drive
    from repro_torch import kernels

    if int(seed) < 0:
        raise ValueError("--seed is a whole number >= 0")
    plan, online = reference.policy(config["policy"])
    kind = traffic["kind"]
    spans = drive.Spans(trace)
    probe = drive.Probe()
    n_inputs = int(traffic.get("inputs", 1))
    insts = [gen.instance(config, traffic, seed, i) for i in range(n_inputs)]
    inputs = [drive.program_inputs(inst, config) for inst in insts]
    if kind == "backlog":
        runner = drive.Backlog(config, traffic, device)

        def unit(i):
            return runner.unit(*inputs[i], spans)
    elif kind == "stream":
        runner = drive.Stream(config, traffic, device)

        def unit(i):
            return runner.unit(*inputs[i], insts[i].arrivals, spans)
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    # The warm pass: each input once.
    for i in range(n_inputs):
        unit(i)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    kernels.reset_launch_counts()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    restore = drive.wrap_entry_points(probe, spans) if trace else None
    prof = devtrace.start() if trace else None
    outs = []
    # No collection pauses inside the window: what it holds is freed
    # after the check.
    gc.collect()
    gc.disable()
    try:
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        while True:
            for i in range(n_inputs):
                outs.append((i, unit(i)))
            _sync(device)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
    finally:
        gc.enable()
    dev = devtrace.read(prof, t0_ns, t1_ns, spans.items,
                        _kernel_names()) if trace else None
    if restore is not None:
        restore()
    launches = kernels.launch_counts()
    peak = int(torch.cuda.max_memory_allocated()) \
        if torch.device(device).type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise ImportError("the run loaded " + ", ".join(found))

    numbers: dict[str, float] = {}
    rec = {"kind": kind, "setup_s": setup_s, "window_s": window_s,
           "units": len(outs), "launches": launches,
           "entry_s": dict(probe.spent), "shapes": probe.shapes,
           "kernels": dev["kernels"] if dev else {},
           "busy_s": dev["busy_s"] if dev else None,
           "trace_window_s": dev["window_s"] if dev else None}
    horizon, u = int(config["horizon"]), float(config["u"])
    want = []
    for inst in insts:
        ref_cl = reference.Cluster.make(inst.capacities, config["cluster"])
        if kind == "backlog":
            s = plan(ref_cl, inst.jobs, horizon, u)
            want.append(((s, reference.simulate(ref_cl, inst.jobs,
                                                s.assignment)), None))
        else:
            s, outcomes = online(ref_cl, inst.jobs, inst.arrivals, horizon, u)
            want.append(((s, reference.simulate(ref_cl, inst.jobs,
                                                s.assignment, inst.arrivals)),
                         outcomes))
    if kind == "backlog":
        for i, (schedule, sim, _) in outs:
            check.merge(numbers, check.schedule_numbers(
                (schedule, sim), want[i][0], len(insts[i].jobs)))
        rec["simulate_s"] = sum(o[2] for _, o in outs)
        attempted, failed = len(outs), 0
    else:
        lat, chooser, append_s, failed, attempted = [], [], 0.0, 0, 0
        for i, o in outs:
            check.merge(numbers, check.schedule_numbers(
                (o["schedule"], o["sim"]), want[i][0], len(insts[i].jobs)))
            check.merge(numbers, check.decision_numbers(o, want[i][1]))
            lat += [t1 - t0_ for _, t0_, t1 in o["store"].decided]
            chooser += o["chooser_s"]
            append_s += o["store"].append_s
            attempted += o["n_jobs"]
            failed += o["n_jobs"] - len(o["schedule"].assignment)
        rec.update(latencies_s=lat, chooser_s=chooser,
                   append_s=append_s, decisions=len(lat))

    correct, checks = check.verdict(numbers)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": {}}
    for m in metrics:
        value = reader(m["name"])(rec)
        if value is not None:
            result["metrics"][m["name"]] = {"value": float(value),
                                            "unit": m["unit"]}
    if torch.device(device).type == "cuda":
        kind_name, count = torch.cuda.get_device_name(0), 1
    else:
        kind_name, count = "cpu", 0
    result["device"] = {"platform": "gpu", "kind": kind_name, "count": count,
                        "memory_peak_bytes": peak}
    if dev:
        result["device"].update(busy_s=dev["busy_s"], window_s=dev["window_s"])
        result["breakdown"] = {"device_ops": dev["device_ops"],
                               "idle_gaps": dev["idle_gaps"]}
    result["checks"] = checks
    result["lines"] = [f"check {k}: {c['value']!r} (limit {c['limit']})"
                       for k, c in checks.items()]
    return result


def _kernel_names() -> list[str]:
    from portbench.roofline import KERNEL_NAMES
    return list(KERNEL_NAMES.values())

