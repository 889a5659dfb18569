"""The port's mLSTM parallel form (K6 plain version) against the JAX reference.

The same NumPy inputs go through the port's ``mlstm_parallel`` (on CPU
tensors: its plain PyTorch version) and through the reference's Pallas
kernel ``repro.kernels.mlstm.mlstm_parallel`` (interpret mode on the CPU,
as ``tests/test_mlstm_kernel.py`` runs it) and its oracle
``repro.kernels.ref.mlstm_parallel``.  Tolerances are those of
``tests/test_mlstm_kernel.py``: 2e-4 in float32, 3e-2 for bfloat16 inputs.
A ragged S is held against the oracle alone (the Pallas wrapper refuses
it).  The model-layout entry point ``ops.mlstm`` and the port's
query-chunked block are held against the reference model's
``ssm._mlstm_parallel_block``.  ``tests/test_torch_gpu.py`` holds the CUDA
kernel against the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.mlstm import mlstm_parallel as ref_kernel
from repro.models.ssm import _mlstm_parallel_block as ref_block
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import mlstm as ml
from repro_torch.models import ssm

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _gates(rng, shape):
    """Realistic gates, as the reference test draws them: forget ~
    sigmoid(3 + N(0,1)) (slow decay), input pre-activations ~ N(0,1)."""
    x = 3.0 + rng.standard_normal(shape)
    F = np.cumsum(-np.logaddexp(0.0, -x), axis=-1 if len(shape) == 2
                  else 1).astype(np.float32)
    return F, rng.standard_normal(shape).astype(np.float32)


def _inputs(BH, S, hd, seed=0):
    """q, k (pre-scaled by 1/sqrt(hd)), v [BH, S, hd]; F, i [BH, S]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, S, hd)).astype(np.float32)
    k = (rng.standard_normal((BH, S, hd)) / np.sqrt(hd)).astype(np.float32)
    v = rng.standard_normal((BH, S, hd)).astype(np.float32)
    F, i = _gates(rng, (BH, S))
    return q, k, v, F, i


def _jax(arrays, dtype=jnp.float32):
    q, k, v, F, i = (jnp.asarray(a) for a in arrays)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype), F, i


def _torch(arrays, dtype=torch.float32):
    q, k, v, F, i = (torch.tensor(a) for a in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), F, i


@pytest.mark.parametrize("BH,S,hd", [(2, 128, 64), (4, 256, 64),
                                     (1, 512, 128), (2, 128, 256),
                                     (1, 256, 512)])
def test_matches_reference_kernel_and_oracle(BH, S, hd):
    arrays = _inputs(BH, S, hd, seed=S + hd)
    before = launch_counts()
    got = ml.mlstm_parallel(*_torch(arrays))
    assert launch_counts() == before         # CPU tensors launch nothing
    assert got.dtype == torch.float32 and got.shape == (BH, S, hd)
    jargs = _jax(arrays)
    for want in (ref_kernel(*jargs, block_q=128, block_k=128),
                 ref.mlstm_parallel(*jargs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("BH,S,hd", [(2, 128, 64), (1, 128, 512)])
def test_bf16_inputs(BH, S, hd):
    """bfloat16 q/k/v (both casts round to nearest even, so both sides
    hold the same values), float32 gates; the output is bfloat16."""
    arrays = _inputs(BH, S, hd, seed=2)
    got = ml.mlstm_parallel(*_torch(arrays, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jargs = _jax(arrays, jnp.bfloat16)
    for want in (ref_kernel(*jargs, block_q=64, block_k=64),
                 ref.mlstm_parallel(*jargs)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("S", [1, 77, 200])
def test_ragged_sequence_matches_oracle(S):
    arrays = _inputs(3, S, 64, seed=S)
    got = ml.mlstm_parallel(*_torch(arrays))
    want = ref.mlstm_parallel(*_jax(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_batch_head_layout_and_out():
    """[B, H, S, hd] inputs equal the folded [BH, S, hd] ones, and ``out``
    receives the result."""
    q, k, v, F, i = _torch(_inputs(6, 128, 64, seed=5))
    folded = ml.mlstm_parallel(q, k, v, F, i)
    out = torch.empty(2, 3, 128, 64)
    got = ml.mlstm_parallel(*(t.reshape(2, 3, *t.shape[1:])
                              for t in (q, k, v, F, i)), out=out)
    assert got is out
    torch.testing.assert_close(out.reshape(6, 128, 64), folded, rtol=0,
                               atol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, F, i = _torch(_inputs(1, 64, 64))
    with pytest.raises(ValueError, match="head dim 48"):
        ml.mlstm_parallel(*(t[..., :48] for t in (q, k, v)), F, i)
    with pytest.raises(TypeError, match="F: dtype"):
        ml.mlstm_parallel(q, k, v, F.double(), i)
    with pytest.raises(ValueError, match="k: "):
        ml.mlstm_parallel(q, k.bfloat16(), v, F, i)
    with pytest.raises(ValueError, match="contiguous"):
        ml.mlstm_parallel(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v, F, i)


def _model_layout(B, S, H, hd, seed):
    """q, k, v [B, S, H, hd] as the model makes them (v pre-scaled by
    1/sqrt(hd), k not), F and i [B, S, H]."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    v = (v / np.sqrt(hd)).astype(np.float32)
    F, i = _gates(rng, (B, S, H))
    return q, k, v, F, i


@pytest.mark.parametrize("B,S,H,hd", [(2, 256, 4, 64), (1, 1024, 2, 128)])
def test_model_layout_matches_reference_block(B, S, H, hd):
    """``ops.mlstm`` (K6's model-layout entry) and the port's chunked
    block against the reference model's ``_mlstm_parallel_block``, with
    H > 1 so that head folding and the v scaling are covered."""
    q, k, v, F, i = _model_layout(B, S, H, hd, seed=S)
    want = np.asarray(ref_block(*(jnp.asarray(a) for a in (q, F, k, v, F,
                                                           i)), 0, S))
    tq, tk, tv, tF, ti = (torch.tensor(a) for a in (q, k, v, F, i))
    got = ops.mlstm(tq, tk, tv, tF, ti)
    assert got.shape == (B, S, H, hd) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, **F32)
    c = S // 2
    chunked = torch.cat([ssm._mlstm_parallel_block(
        tq[:, t0:t0 + c], tF[:, t0:t0 + c], tk, tv, tF, ti, t0)
        for t0 in (0, c)], dim=1)
    np.testing.assert_allclose(chunked.numpy(), want, **F32)


def _model_views(dtype=torch.float32):
    """q/k/v [B, H, S, hd] as ops.mlstm hands them over: transposed views
    of one [B, S, 3*H*hd] product's thirds (B 2, S 150, H 4, hd 64)."""
    qkv = torch.zeros(2, 150, 3 * 4 * 64, dtype=dtype)
    return [t.reshape(2, 150, 4, 64).transpose(1, 2)
            for t in qkv.chunk(3, dim=-1)]


@pytest.mark.parametrize("case,in_place", [
    ("contiguous float32", True),
    ("model-layout views", True),
    ("size-1 dims of odd strides", True),
    ("one element off its allocation", False),
    ("rows 258 elements apart", False),
    ("heads 2 elements apart", False),
    ("bfloat16", False),
])
def test_kernel_reads_in_place_only_16_byte_rows(case, in_place):
    """The CUDA wrapper hands K6 an operand as it is only where every row
    starts on 16 bytes, which its cp.async copies need: float32, an aligned
    base and batch, head and sequence strides that are multiples of 4
    elements (a dim of size 1 never moves a row).  Any other operand goes
    in as a float32 copy.  The rule is a pure function of the tensor,
    pinned here on CPU tensors (their allocations are 64-byte aligned)."""
    t = {
        "contiguous float32": lambda: torch.zeros(2, 4, 150, 64),
        "model-layout views": lambda: _model_views()[1],
        "size-1 dims of odd strides": lambda: torch.zeros(150 * 64)
        .as_strided((1, 1, 150, 64), (3, 5, 64, 1)),
        "one element off its allocation": lambda: torch.zeros(
            2, 4, 150, 65)[..., 1:],
        "rows 258 elements apart": lambda: torch.zeros(2, 150, 258)[
            ..., :256].unflatten(-1, (4, 64)).transpose(1, 2),
        "heads 2 elements apart": lambda: torch.zeros(2, 150, 4 * 66)
        .as_strided((2, 4, 150, 64), (150 * 264, 66, 264, 1)),
        "bfloat16": lambda: _model_views(torch.bfloat16)[0],
    }[case]()
    assert t.shape[-1] == 64 and t.stride(-1) == 1
    assert ml._reads_in_place(t) is in_place
    copy = ml._kernel_operand(t)
    assert (copy is t) is in_place
    if not in_place:
        assert copy.dtype == torch.float32 and copy.is_contiguous()
        torch.testing.assert_close(copy, t.float(), rtol=0, atol=0)
