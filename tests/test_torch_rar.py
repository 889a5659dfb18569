"""The port's ring-all-reduce (``repro_torch.dist.rar``) against the JAX
reference ring, on the CPU.

The reference ring is one SPMD program over forced host devices
(``jax.shard_map`` over a 1-D ``"data"`` mesh).  All its cases run in ONE
subprocess per module (the pattern of ``tests/test_rar.py``, so the
forced device count never leaks into this process): a module-scoped
fixture writes the numpy-seeded inputs to an ``.npz`` under a temporary
directory, the subprocess writes every case's per-worker outputs to a
second ``.npz``, and each case below reads its arrays from there.  The
port runs the same inputs as worker-stacked tensors (row ``i`` = worker
``i``) and must agree **bitwise**: each ring step adds in the reference's
order.  bfloat16 inputs are bf16-representable values carried as float32
in the files and cast on each side.

Also held: the ring's step and byte counters against ``2(w - 1)`` and
``exchange_bytes_per_worker``, the formula on a (d, w) grid and its
``w < 1`` error, ``out=`` written in place, and that the port's training
modules import neither JAX nor the reference.
"""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.dist.rar import exchange_bytes_per_worker as ref_exchange
from repro_torch.dist import rar

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = (1, 2, 3, 4, 5, 8)
SIZES = (1, 7, 37, 100)
DTYPES = ("float32", "bfloat16")
MULTIDIM = (5, 3)
PHASE_CASES = [(w, n) for w in (2, 3, 4, 5, 8) for n in (7, 37)]

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist.rar import ring_all_gather, ring_all_reduce, ring_reduce_scatter

inp = dict(np.load(sys.argv[1]))
out = {}

def run(fn, x, w):
    mesh = Mesh(np.asarray(jax.devices()[:w]), ("data",))
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("data"),
                              out_specs=P("data")))
    return np.asarray(f(x).astype(jnp.float32))

for key, x in inp.items():
    kind, w, dt = key.split("|")[0], int(key.split("|")[1]), key.split("|")[-1]
    x = jnp.asarray(x).astype(getattr(jnp, dt))
    if kind == "ar":
        out[key] = run(lambda v: ring_all_reduce(v, "data"), x, w)
    elif kind == "rs":
        out[key] = run(lambda v: ring_reduce_scatter(v[0], "data")[None], x, w)
    elif kind == "ag":
        out[key] = run(lambda v: ring_all_gather(v[0], "data")[None], x, w)
np.savez(sys.argv[2], **out)
"""


def _values(rng, shape, dtype):
    """float32 values, bf16-representable when ``dtype`` is bfloat16."""
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32) * 3)
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16).to(torch.float32)
    return x.numpy()


def _inputs() -> dict:
    rng = np.random.default_rng(2022)
    inp = {}
    for w in WIDTHS:
        for n in SIZES:
            for dt in DTYPES:
                inp[f"ar|{w}|{n}|{dt}"] = _values(rng, (w, n), dt)
    for dt in DTYPES:
        inp[f"ar|4|md|{dt}"] = _values(rng, (4,) + MULTIDIM, dt)
    for w, n in PHASE_CASES:
        inp[f"rs|{w}|{n}|float32"] = _values(rng, (w, n), "float32")
        inp[f"ag|{w}|{n}|float32"] = _values(rng, (w, n), "float32")
    return inp


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(inputs, the reference ring's outputs), every case from one
    subprocess over 8 forced host devices."""
    tmp = tmp_path_factory.mktemp("ring")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return inp, dict(np.load(tmp / "out.npz"))


def _port(x: np.ndarray, dt: str) -> torch.Tensor:
    return torch.tensor(x).to(getattr(torch, dt))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy().view(np.uint32)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("w", WIDTHS)
def test_all_reduce_bitwise_equals_reference(reference, w, n, dt):
    inp, ref = reference
    key = f"ar|{w}|{n}|{dt}"
    got = rar.ring_all_reduce(_port(inp[key], dt))
    assert got.dtype == getattr(torch, dt) and got.shape == (w, n)
    np.testing.assert_array_equal(_bits(got), ref[key].view(np.uint32))


@pytest.mark.parametrize("dt", DTYPES)
def test_multidim_all_reduce_keeps_shape_and_bits(reference, dt):
    inp, ref = reference
    key = f"ar|4|md|{dt}"
    got = rar.ring_all_reduce(_port(inp[key], dt))
    assert got.shape == (4,) + MULTIDIM
    np.testing.assert_array_equal(_bits(got), ref[key].view(np.uint32))


@pytest.mark.parametrize("w,n", PHASE_CASES)
def test_reduce_scatter_chunks_equal_reference(reference, w, n):
    inp, ref = reference
    key = f"rs|{w}|{n}|float32"
    got = rar.ring_reduce_scatter(torch.tensor(inp[key]))
    m = -(-n // w)
    assert got.shape == (w, m)
    np.testing.assert_array_equal(_bits(got), ref[key].view(np.uint32))
    flat = got.reshape(-1)
    assert torch.equal(flat[n:], torch.zeros(m * w - n))       # the padding


@pytest.mark.parametrize("w,n", PHASE_CASES)
def test_all_gather_equals_reference(reference, w, n):
    inp, ref = reference
    key = f"ag|{w}|{n}|float32"
    got = rar.ring_all_gather(torch.tensor(inp[key]))
    assert got.shape == (w, w * n)
    np.testing.assert_array_equal(_bits(got), ref[key].view(np.uint32))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("w", WIDTHS)
def test_ring_counts_steps_and_bytes(w, n):
    """2(w - 1) steps; each worker sends one chunk a step, which is
    ``exchange_bytes_per_worker`` of the zero-padded gradient."""
    x = torch.ones((w, n), dtype=torch.float32)
    rar.reset_ring_counts()
    rar.ring_all_reduce(x)
    m = -(-n // w)
    got = rar.ring_counts()
    assert got["steps"] == 2 * (w - 1)
    assert got["bytes"] == rar.exchange_bytes_per_worker(4 * m * w, w)
    if n % w == 0:
        assert got["bytes"] == rar.exchange_bytes_per_worker(4 * n, w)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 7, 8, 64, 1000])
@pytest.mark.parametrize("d", [0.0, 1.0, 4e6, 1.5e9])
def test_exchange_bytes_equals_reference(d, w):
    assert rar.exchange_bytes_per_worker(d, w) == ref_exchange(d, w)


@pytest.mark.parametrize("w", [0, -1])
def test_exchange_bytes_rejects_an_empty_ring(w):
    with pytest.raises(ValueError, match="ring width must be >= 1"):
        rar.exchange_bytes_per_worker(1.0, w)


def test_single_worker_ring_is_the_identity():
    x = torch.randn(1, 7)
    rar.reset_ring_counts()
    assert torch.equal(rar.ring_all_reduce(x), x)
    assert rar.ring_counts() == {"steps": 0, "bytes": 0}


@pytest.mark.parametrize("n", [8, 10])
def test_all_reduce_into_its_own_input(n):
    """``out=x``: the result replaces the input, the same bits as a fresh
    result (the chip's path for a llama3.2-1b-sized gradient)."""
    x = torch.tensor(np.random.default_rng(n).standard_normal((4, n)),
                     dtype=torch.float32)
    fresh = rar.ring_all_reduce(x)
    assert rar.ring_all_reduce(x, out=x) is x
    assert torch.equal(x, fresh)


def test_out_of_the_wrong_shape_is_refused():
    with pytest.raises(ValueError, match="out:"):
        rar.ring_all_reduce(torch.ones(2, 4), out=torch.empty(2, 5))


def test_axis_size_is_the_worker_axis():
    assert rar.axis_size(torch.empty(5, 3)) == 5
    with pytest.raises(ValueError):
        rar.axis_size(torch.tensor(1.0))


PORT_TRAINING_MODULES = (
    "dist/rar.py", "dist/steps.py", "optim/adamw.py", "data/pipeline.py",
    "ckpt/checkpoint.py", "launch/train.py", "launch/sched_launch.py",
    "tree.py")


@pytest.mark.parametrize("rel", PORT_TRAINING_MODULES)
def test_port_training_module_imports_no_jax_and_no_reference(rel):
    src = (ROOT / "src" / "repro_torch" / rel).read_text()
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    assert not bad.search(src), bad.search(src).group(0)
    assert "torch.distributed" not in src and "multiprocessing" not in src
