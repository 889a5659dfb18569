"""The port's training substrate against the JAX reference, on the CPU.

Both packages get the same numpy-seeded inputs in this one process:

* **AdamW** (``repro_torch.optim.adamw``): ``apply`` on random trees with
  float32 and bfloat16 moments, clipping on and off, at steps 1, 50 and
  150 of the schedule; new params within 1e-6 and moments within 1e-6 of
  the reference (relative to each leaf's largest value; measured: params
  8.2e-11, m 5.1e-8, v 7.0e-10), the grad norm within 1e-6 (measured
  8.2e-8, a float32 sum in another order), the learning rate equal;
  ``schedule`` equal in the warm-up and within 1e-6 in the cosine
  (measured 2.4e-7: XLA's and PyTorch's cos differ in the last bit);
  ``init`` and ``global_norm`` too.
* **Data**: ``make_batch`` equal to the reference's arrays for the dense,
  vlm, ssm and audio configs, and the iterator.  The seed includes
  ``hash(cfg.name)``, which Python randomises per process: both packages
  are compared within this process only.
* **Checkpoints**: the port's float32 file loads in the reference
  bitwise; the reference's float32 and bfloat16-moment files load in the
  port bitwise (bfloat16 leaves are raw ``|V2`` records); the same key
  set; the port's own bfloat16 round trip; shape-mismatch and missing-key
  errors.
* **Steps** on reduced llama3.2-1b, xlstm-350m and internvl2-1b (and,
  for the one-step and gradient checks, deepseek-moe-16b, hymba-1.5b and
  whisper-tiny) in float32, params carried with
  ``params_from_reference`` and AdamW state with ``opt_from_reference``.
  One step from a state the reference trained for three steps: loss
  within 1e-3 and params within 2e-4 (the
  bounds of the reference's own ``test_grad_accumulation_matches_full_
  batch``; measured: loss 2.4e-6, params 6.1e-6).  From a fresh state the
  first AdamW step is a sign step (m/sqrt(v) = g/|g|), so a gradient
  element within rounding noise of zero moves its param by up to 2 lr
  (measured: llama3.2-1b 3.0e-4, xlstm-350m 1.2e-3 on this file's
  batches); there the tests hold the loss and the gradients instead.
  xlstm-350m's mLSTM signed denominator amplifies rounding in the
  backward, so its gradients carry ~1e-4 relative noise (the reference's
  own jit and eager gradients differ by 1.3e-4).  The gradients are held
  within 1e-3 of each leaf's largest value (measured: xlstm 1.1e-4,
  dense/vlm 1.8e-6).  ``grad_accum_steps`` 4 against 1 at the reference's
  bounds; the RAR step at w in {1, 2, 4} against the reference's
  single-program step on the same (concatenated) batch and the port's,
  within 2e-4 (measured 6.1e-6 and 3.2e-6), with every ring row bitwise
  equal.
* **Launchers**, in process on ``--device cpu``: ``train`` in RAR mode
  writing a checkpoint that the reference's ``ckpt.load`` reads bitwise;
  ``sched_launch``'s schedule and simulated makespan equal to the
  reference's ``get_policy`` plus ``simulate`` (the reference's own
  launcher cannot execute its RAR step on this host), with 3 jobs and
  with 6, where every family of its pool trains.

No assertion here depends on a "loss went down" outcome of hash-seeded
data; losses are held finite.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.core import Cluster as RefCluster
from repro.core import Job as RefJob
from repro.core import ScheduleRequest as RefRequest
from repro.core import get_policy as ref_get_policy
from repro.core import simulate as ref_simulate
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_iterator as ref_batch_iterator
from repro.data import make_batch as ref_make_batch
from repro.dist.steps import _grads_and_loss as ref_grads_and_loss
from repro.dist.steps import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.models.config import InputShape as RefInputShape
from repro.models.layers import bf16_grad_barrier as ref_barrier
from repro.optim import adamw as ref_adamw
from repro_torch import ckpt, configs
from repro_torch.convert import opt_from_reference, params_from_reference
from repro_torch.data import DataConfig, batch_iterator, make_batch
from repro_torch.dist import steps
from repro_torch.dist.steps import (RingMesh, make_rar_train_step,
                                    make_train_step)
from repro_torch.kernels import _build
from repro_torch.kernels import rmsnorm as rn
from repro_torch.launch import sched_launch, train
from repro_torch.models import build_model
from repro_torch.models.config import InputShape
from repro_torch.models.layers import bf16_grad_barrier
from repro_torch.optim import adamw
from repro_torch.tree import leaves

ARCHS = ("llama3.2-1b", "xlstm-350m", "internvl2-1b")
FAMILY_ARCHS = ("deepseek-moe-16b", "hymba-1.5b", "whisper-tiny")
LOSS_TOL, PARAM_TOL = 1e-3, 2e-4          # test_substrate.py's bounds
GRAD_REL_TOL = 1e-3
SEQ = 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _max_abs(ref_tree, port_tree) -> float:
    ref = jax.tree.leaves(ref_tree)
    port = leaves(port_tree)
    assert len(ref) == len(port)
    return max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - b.to(torch.float32).numpy())))
               for a, b in zip(ref, port))


def _max_rel(ref_tree, port_tree) -> float:
    """Largest difference of a leaf over that leaf's largest magnitude."""
    return max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - b.to(torch.float32).numpy()))
                     / max(float(np.max(np.abs(np.asarray(a, np.float32)))),
                           1e-30))
               for a, b in zip(jax.tree.leaves(ref_tree), leaves(port_tree)))


def _bitwise(ref_tree, port_tree) -> bool:
    ref = jax.tree.leaves(ref_tree)
    port = leaves(port_tree)
    return len(ref) == len(port) and all(
        np.asarray(a).dtype.itemsize == b.element_size()
        and np.array_equal(np.asarray(a).view(f"u{b.element_size()}"),
                           b.contiguous().view(
                               {2: torch.int16, 4: torch.int32,
                                8: torch.int64}[b.element_size()]).numpy()
                           .view(f"u{b.element_size()}"))
        for a, b in zip(ref, port))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

SHAPES = {"a": (17, 3), "b": {"c": (5,), "d": (4, 2, 3)},
          "e": [(64,), (2, 8)]}


def _random_tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _random_tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_random_tree(rng, v, scale) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.tensor(np.asarray(tree))


def _configs(**kw):
    return ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)


@pytest.mark.parametrize("step", [1, 50, 150])
@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_adamw_apply_matches_reference(seed, moments, clip, step):
    rng = np.random.default_rng(seed)
    p, g = _random_tree(rng, SHAPES), _random_tree(rng, SHAPES, 0.5)
    m = _random_tree(rng, SHAPES, 0.1)
    v = jax.tree.map(np.abs, _random_tree(rng, SHAPES, 0.1))
    rcfg, pcfg = _configs(lr=1e-3, warmup_steps=100, total_steps=200,
                          clip_norm=clip, moment_dtype=moments)
    rstate = {"m": jax.tree.map(lambda x: jnp.asarray(x, moments), m),
              "v": jax.tree.map(lambda x: jnp.asarray(x, moments), v),
              "step": jnp.asarray(step - 1, jnp.int32)}
    rp, ro, rm = ref_adamw.apply(rcfg, jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, p), rstate)
    pp, po, pm = adamw.apply(pcfg, _torch_tree(g), _torch_tree(p),
                             opt_from_reference(_np_tree(rstate),
                                                _torch_tree(p), "cpu"))
    assert _max_rel(rp, pp) <= 1e-6
    assert _max_rel(ro["m"], po["m"]) <= 1e-6
    assert _max_rel(ro["v"], po["v"]) <= 1e-6
    assert all(t.dtype == getattr(torch, moments)
               for t in leaves(po["m"]) + leaves(po["v"]))
    assert int(po["step"]) == int(ro["step"]) == step
    assert po["step"].dtype == torch.int32
    assert float(pm["lr"]) == float(rm["lr"])
    assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) \
        <= 1e-6 * float(rm["grad_norm"])


def test_adamw_schedule_equals_reference():
    rcfg, pcfg = _configs(lr=3e-4, warmup_steps=100, total_steps=1000)
    steps_ = np.arange(0, 1200, 7, dtype=np.int32)
    ref = np.asarray(ref_adamw.schedule(rcfg, jnp.asarray(steps_)))
    got = adamw.schedule(pcfg, torch.tensor(steps_)).numpy()
    warm = steps_ < 100
    np.testing.assert_array_equal(got[warm], ref[warm])
    # the cosine's last bit (XLA's and PyTorch's cos; measured 2.4e-7)
    np.testing.assert_allclose(got[~warm], ref[~warm], rtol=1e-6, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_init_matches_reference(moments):
    rng = np.random.default_rng(5)
    p = _random_tree(rng, SHAPES)
    rcfg, pcfg = _configs(moment_dtype=moments)
    ref = ref_adamw.init(rcfg, jax.tree.map(jnp.asarray, p))
    got = adamw.init(pcfg, _torch_tree(p))
    assert sorted(got) == sorted(ref)
    assert _bitwise(ref["m"], got["m"]) and _bitwise(ref["v"], got["v"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0


def test_adamw_global_norm_matches_reference():
    rng = np.random.default_rng(6)
    tree = _random_tree(rng, SHAPES)
    ref = float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(adamw.global_norm(_torch_tree(tree)))
    assert abs(got - ref) <= 1e-6 * ref


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

DATA_ARCHS = ("llama3.2-1b", "internvl2-1b", "xlstm-350m", "whisper-tiny")


@pytest.mark.parametrize("arch", DATA_ARCHS)
@pytest.mark.parametrize("step,batch_override", [(0, None), (7, 3)])
def test_make_batch_equals_reference(arch, step, batch_override):
    rcfg = ref_get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    ref = ref_make_batch(rcfg, RefInputShape("t", 48, 4, "train"), step,
                         RefDataConfig(seed=3), batch_override)
    got = make_batch(cfg, InputShape("t", 48, 4, "train"), step,
                     DataConfig(seed=3), batch_override, device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == {np.dtype(np.int32): torch.int32,
                                np.dtype(np.float32): torch.float32
                                }[ref[k].dtype]
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_batch_iterator_equals_reference():
    rcfg = ref_get_config("llama3.2-1b").reduced()
    cfg = configs.get_config("llama3.2-1b").reduced()
    ref = ref_batch_iterator(rcfg, RefInputShape("t", 16, 2, "train"))
    got = batch_iterator(cfg, InputShape("t", 16, 2, "train"), device="cpu")
    for step in range(3):
        a, b = next(ref), next(got)
        np.testing.assert_array_equal(b["tokens"].numpy(), a["tokens"])
        np.testing.assert_array_equal(
            b["tokens"].numpy(),
            make_batch(cfg, InputShape("t", 16, 2, "train"), step,
                       device="cpu")["tokens"].numpy())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_trees():
    """(reference params, reference f32 opt, reference bf16 opt) of the
    reduced llama3.2-1b, built once."""
    cfg = ref_get_config("llama3.2-1b").reduced()
    params = ref_build_model(cfg, max_seq=SEQ).init(jax.random.PRNGKey(0))
    opt32 = ref_adamw.init(ref_adamw.AdamWConfig(), params)
    opt16 = ref_adamw.init(ref_adamw.AdamWConfig(moment_dtype="bfloat16"),
                           params)
    rng = np.random.default_rng(9)
    fill = lambda o: {**o, "m": jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), x.dtype), o["m"]),
        "step": jnp.asarray(17, jnp.int32)}
    return params, fill(opt32), fill(opt16)


def _port_cfg():
    return configs.get_config("llama3.2-1b").reduced()


def test_port_checkpoint_loads_in_reference_bitwise(small_trees, tmp_path):
    rparams, ropt, _ = small_trees
    params = params_from_reference(_np_tree(rparams), _port_cfg(), "cpu")
    opt = opt_from_reference(_np_tree(ropt), params, "cpu")
    path = str(tmp_path / "port.npz")
    ckpt.save(path, params=params, opt_state=opt, step=17)
    zeros = jax.tree.map(jnp.zeros_like, (rparams, ropt))
    lp, lo, step = ref_ckpt.load(path, params_like=zeros[0],
                                 opt_like=zeros[1])
    assert step == 17
    assert _bitwise(lp, params) and _bitwise(lo, opt)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_in_port_bitwise(small_trees, tmp_path,
                                                    moments):
    rparams, ropt32, ropt16 = small_trees
    ropt = ropt32 if moments == "float32" else ropt16
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save(path, params=rparams, opt_state=ropt, step=5)
    like = params_from_reference(_np_tree(rparams), _port_cfg(), "cpu")
    pcfg = adamw.AdamWConfig(moment_dtype=moments)
    params, opt, step = ckpt.load(path, params_like=like,
                                  opt_like=adamw.init(pcfg, like))
    assert step == 5
    assert _bitwise(rparams, params) and _bitwise(ropt, opt)
    assert leaves(opt["m"])[0].dtype == getattr(torch, moments)


def test_both_packages_write_the_same_keys(small_trees, tmp_path):
    rparams, ropt, _ = small_trees
    ref_ckpt.save(str(tmp_path / "ref.npz"), params=rparams, opt_state=ropt,
                  step=1)
    params = params_from_reference(_np_tree(rparams), _port_cfg(), "cpu")
    ckpt.save(str(tmp_path / "port.npz"), params=params,
              opt_state=opt_from_reference(_np_tree(ropt), params, "cpu"),
              step=1)
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape


def test_port_bf16_round_trip(tmp_path):
    rng = np.random.default_rng(11)
    params = {"w": torch.tensor(rng.standard_normal((7, 5)),
                                dtype=torch.bfloat16),
              "layers": [torch.tensor(rng.standard_normal(3),
                                      dtype=torch.float32)]}
    opt = adamw.init(adamw.AdamWConfig(moment_dtype="bfloat16"), params)
    opt["m"]["w"] = torch.tensor(rng.standard_normal((7, 5)),
                                 dtype=torch.bfloat16)
    path = str(tmp_path / "bf16.npz")
    ckpt.save(path, params=params, opt_state=opt, step=3)
    with np.load(path) as data:
        assert data["params/w"].dtype == np.dtype("V2")
        assert data["opt/m/w"].dtype == np.dtype("V2")
    like = {"w": torch.zeros((7, 5), dtype=torch.bfloat16),
            "layers": [torch.zeros(3)]}
    got, gopt, step = ckpt.load(path, params_like=like,
                                opt_like=adamw.init(adamw.AdamWConfig(
                                    moment_dtype="bfloat16"), like))
    assert step == 3
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16),
                       params["w"].view(torch.int16))
    assert torch.equal(got["layers"][0], params["layers"][0])
    assert torch.equal(gopt["m"]["w"].view(torch.int16),
                       opt["m"]["w"].view(torch.int16))


def test_checkpoint_shape_mismatch_and_missing_key_raise(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, params={"a": torch.ones(3)}, step=0)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load(path, params_like={"a": torch.ones(4)})
    with pytest.raises(KeyError):
        ckpt.load(path, params_like={"a": torch.ones(3), "b": torch.ones(1)})


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _batches(cfg, rng, B):
    n_txt = SEQ - cfg.n_patches if cfg.family == "vlm" else SEQ
    tok = rng.integers(0, cfg.vocab, (B, n_txt)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(tok)}, {"tokens": torch.tensor(tok)}
    if cfg.family == "vlm":
        pa = rng.standard_normal((B, cfg.n_patches, cfg.d_model)
                                 ).astype(np.float32)
        ref["patches"], port["patches"] = jnp.asarray(pa), torch.tensor(pa)
    if cfg.family == "audio":
        fr = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)
                                 ).astype(np.float32)
        ref["frames"], port["frames"] = jnp.asarray(fr), torch.tensor(fr)
    return ref, port


OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)


@pytest.fixture(scope="module")
def trained():
    """Per arch: the reference's and the port's model, the fresh params,
    a state the reference trained for three steps (carried to the port
    bit for bit), one batch, and each package's single-program step from
    that state."""
    memo = {}

    def get(arch):
        if arch not in memo:
            rcfg = ref_get_config(arch).reduced()
            cfg = configs.get_config(arch).reduced()
            rmodel = ref_build_model(rcfg, max_seq=64)
            rp0 = rmodel.init(jax.random.PRNGKey(0))
            rcfg_o = ref_adamw.AdamWConfig(**OCFG)
            rstep = jax.jit(ref_make_train_step(rmodel, rcfg_o))
            rng = np.random.default_rng(3)
            rp, ropt = rp0, ref_adamw.init(rcfg_o, rp0)
            for _ in range(3):
                rp, ropt, _ = rstep(rp, ropt, _batches(cfg, rng, 8)[0])
            rb, pb = _batches(cfg, rng, 8)
            model = build_model(cfg, 64, device="cpu")
            pw = params_from_reference(_np_tree(rp), cfg, "cpu")
            popt = opt_from_reference(_np_tree(ropt), pw, "cpu")
            memo[arch] = dict(
                rmodel=rmodel, model=model, rb=rb, pb=pb,
                fresh=(rp0, params_from_reference(_np_tree(rp0), cfg, "cpu")),
                warm=(pw, popt),
                ref_warm=rstep(rp, ropt, rb),
                port_warm=make_train_step(model, adamw.AdamWConfig(**OCFG))(
                    pw, popt, pb))
        return memo[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_train_step_matches_reference_from_a_trained_state(trained, arch):
    case = trained(arch)
    new_p, new_o, m = case["port_warm"]
    rp, ro, rm = case["ref_warm"]
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL
    assert _max_abs(rp, new_p) <= PARAM_TOL
    assert _max_abs(ro["m"], new_o["m"]) <= PARAM_TOL
    assert int(new_o["step"]) == 4


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_gradients_match_reference(trained, arch):
    case = trained(arch)
    rp, pp = case["fresh"]
    ocfg = adamw.AdamWConfig(**OCFG)
    rg, rl = jax.jit(lambda p, b: ref_grads_and_loss(
        case["rmodel"], ref_adamw.AdamWConfig(**OCFG), p, b))(rp, case["rb"])
    pg, pl = steps._grads_and_loss(case["model"], ocfg, pp, case["pb"])
    assert abs(float(pl) - float(rl)) <= LOSS_TOL
    assert _max_rel(rg, pg) <= GRAD_REL_TOL
    assert not any(t.requires_grad for t in leaves(pg))


def test_grad_accumulation_matches_full_batch():
    """The reference's own check on the port: 4 microbatches against 1."""
    cfg = configs.get_config("llama3.2-1b").reduced()
    model = build_model(cfg, 32, device="cpu")
    params = model.init(0)
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (8, 32)), dtype=torch.int32)
    out = {}
    for A in (1, 4):
        ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=5,
                                 grad_accum_steps=A)
        out[A] = make_train_step(model, ocfg)(params, adamw.init(ocfg, params),
                                              {"tokens": tokens})
    assert abs(float(out[1][2]["loss"]) - float(out[4][2]["loss"])) < LOSS_TOL
    d = max(float((a - b).abs().max())
            for a, b in zip(leaves(out[1][0]), leaves(out[4][0])))
    assert d < PARAM_TOL


def test_grad_accumulation_rejects_an_uneven_split():
    cfg = configs.get_config("llama3.2-1b").reduced()
    model = build_model(cfg, 32, device="cpu")
    ocfg = adamw.AdamWConfig(grad_accum_steps=4)
    params = model.init(0)
    with pytest.raises(ValueError, match="divisible by grad_accum_steps=4"):
        make_train_step(model, ocfg)(params, adamw.init(ocfg, params),
                                     {"tokens": torch.zeros((6, 8),
                                                            dtype=torch.int32)})


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_rar_step_matches_single_program_steps(trained, arch, w, monkeypatch):
    """The ring-averaged update against the reference's and the port's
    single-program step on the same batch; every ring row the same bits."""
    case = trained(arch)
    pp, popt = case["warm"]
    ocfg = adamw.AdamWConfig(**OCFG)
    rows = []
    ring = steps.ring_all_reduce

    def spy(buf, **kw):
        out = ring(buf, **kw)
        rows.append(out.clone())
        return out

    monkeypatch.setattr(steps, "ring_all_reduce", spy)
    new_p, new_o, m = make_rar_train_step(
        case["model"], ocfg, RingMesh(range(w), "cpu"))(pp, popt, case["pb"])
    single_p, _, sm = case["port_warm"]
    rp, _, rm = case["ref_warm"]
    assert m["replicated"] is True
    if w > 1:
        (buf,) = rows
        assert buf.shape[0] == w
        assert all(torch.equal(buf[i], buf[0]) for i in range(w))
    else:
        assert not rows
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL
    assert abs(float(m["loss"]) - float(sm["loss"])) <= LOSS_TOL
    assert _max_abs(rp, new_p) <= PARAM_TOL
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(single_p), leaves(new_p))) <= PARAM_TOL
    assert math.isfinite(float(m["grad_norm"]))


@pytest.mark.parametrize("compute,tol", [("bfloat16", 1e-2),
                                         ("float32", 1e-6)])
def test_ring_averaged_gradient_near_the_single_program_gradient(
        compute, tol, monkeypatch):
    """The bound ``chip_smoke.py`` holds at full width: the relative L2 gap
    between the ring-averaged gradient (w = 4) and the single-program
    gradient of the same batch of 8 x 256 tokens.  Measured at reduced
    width on the CPU: 3.2e-3 to 3.8e-3 in bf16 compute (the workers'
    smaller products round differently), 6.7e-8 in float32."""
    cfg = dataclasses.replace(configs.get_config("llama3.2-1b").reduced(),
                              compute_dtype=compute)
    model = build_model(cfg, 256, device="cpu")
    params = model.init(0)
    ocfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=5)
    batch = {"tokens": torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 256)), dtype=torch.int32)}
    got = {}
    ring = steps.ring_all_reduce

    def capture(buf, **kw):
        out = ring(buf, **kw)
        got["g"] = out[0] / 4
        return out

    monkeypatch.setattr(steps, "ring_all_reduce", capture)
    make_rar_train_step(model, ocfg, RingMesh(range(4), "cpu"))(
        params, adamw.init(ocfg, params), batch)
    grads, _ = steps._grads_and_loss(model, ocfg, params, batch)
    single = torch.cat([g.reshape(-1) for g in leaves(grads)])
    assert float((got["g"] - single).norm() / single.norm()) <= tol


def test_rar_step_at_one_worker_is_the_single_program_step(trained):
    case = trained("llama3.2-1b")
    pp, popt = case["warm"]
    a = make_rar_train_step(case["model"], adamw.AdamWConfig(**OCFG),
                            RingMesh([3], "cpu"))(pp, popt, case["pb"])
    b = case["port_warm"]
    assert all(torch.equal(x, y) for x, y in zip(leaves(a[0]), leaves(b[0])))


def test_rar_step_refuses_a_mesh_without_the_data_axis():
    model = build_model(configs.get_config("llama3.2-1b").reduced(), 32,
                        device="cpu")
    with pytest.raises(ValueError, match="must carry a 'data' axis"):
        make_rar_train_step(model, adamw.AdamWConfig(),
                            RingMesh([0, 1], "cpu", axis_names=("model",)))
    with pytest.raises(ValueError, match="1-D"):
        RingMesh([0, 1], "cpu", axis_names=("data", "model"))
    with pytest.raises(ValueError, match="at least one GPU"):
        RingMesh([], "cpu")


def test_rar_step_refuses_a_batch_that_does_not_divide():
    cfg = configs.get_config("llama3.2-1b").reduced()
    model = build_model(cfg, 32, device="cpu")
    ocfg = adamw.AdamWConfig()
    params = model.init(0)
    step = make_rar_train_step(model, ocfg, RingMesh(range(4), "cpu"))
    with pytest.raises(ValueError, match="must divide over the ring"):
        step(params, adamw.init(ocfg, params),
             {"tokens": torch.zeros((6, 8), dtype=torch.int32)})
    elsewhere = {k: v.to("meta") for k, v in params.items()
                 if not isinstance(v, dict)}
    with pytest.raises(ValueError, match="params on meta, the ring on cpu"):
        step(elsewhere, None, {"tokens": torch.zeros((4, 8),
                                                     dtype=torch.int32)})


def test_bf16_grad_barrier_matches_reference():
    x = np.random.default_rng(4).standard_normal(16).astype(np.float32)
    c = np.random.default_rng(5).standard_normal(16).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(ref_barrier(v) * jnp.asarray(c)))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = bf16_grad_barrier(xt)
    assert torch.equal(y, xt)
    (got,) = torch.autograd.grad((y * torch.tensor(c)).sum(), xt)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the kernels refuse autograd
# ---------------------------------------------------------------------------


def test_refuse_autograd_rule():
    plain = torch.ones(3)
    tracked = torch.ones(3, requires_grad=True)
    _build.refuse_autograd("k", plain, None)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_autograd("k", plain, tracked)
    with torch.no_grad():
        _build.refuse_autograd("k", plain, tracked)
    with torch.inference_mode():
        _build.refuse_autograd("k", torch.ones(2))


def test_plain_versions_stay_differentiable_on_the_cpu():
    x = torch.randn(4, 8, requires_grad=True)
    y = rn.rmsnorm(x, torch.ones(8))
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.shape == x.shape


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def test_train_cli_rar_writes_a_checkpoint_the_reference_reads(tmp_path,
                                                               capsys):
    res = train.main(["--reduced", "--mode", "rar", "--devices", "2",
                      "--steps", "3", "--seq", "32", "--batch", "4",
                      "--ckpt-every", "1", "--ckpt-dir", str(tmp_path),
                      "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "2 device(s) on cpu, mode=rar" in out
    assert len(res["losses"]) == 3
    assert all(math.isfinite(x) for x in res["losses"])
    assert [p.rsplit("_", 1)[-1] for p in res["checkpoints"]] == \
        ["1.npz", "2.npz"]
    rcfg = ref_get_config("llama3.2-1b").reduced()
    rparams = ref_build_model(rcfg, max_seq=32).init(jax.random.PRNGKey(0))
    ropt = ref_adamw.init(ref_adamw.AdamWConfig(), rparams)
    lp, lo, step = ref_ckpt.load(res["checkpoints"][-1], params_like=rparams,
                                 opt_like=ropt)
    assert step == 2
    assert _bitwise(lp, res["params"]) and _bitwise(lo, res["opt"])


def test_train_cli_pjit_mode_runs(capsys):
    res = train.main(["--reduced", "--arch", "xlstm-350m", "--steps", "2",
                      "--seq", "16", "--batch", "2", "--device", "cpu"])
    assert "mode=pjit" in capsys.readouterr().out
    assert all(math.isfinite(x) for x in res["losses"])


def _reference_schedule(devices, servers, n_jobs, policy, seed):
    """The reference launcher's scheduling half, in process: the same
    cluster and job queue, ``get_policy`` and ``simulate``."""
    per_srv = devices // servers
    cluster = RefCluster(capacities=(per_srv,) * servers)
    rng = np.random.default_rng(seed)
    jobs = []
    for j in range(n_jobs):
        g = int(rng.choice([1, 2, min(4, devices)]))
        jobs.append(RefJob(jid=j, num_gpus=g,
                           iters=int(rng.integers(1000, 3000)),
                           grad_size=float(rng.uniform(5e-4, 2e-3)),
                           batch=32, dt_fwd=3e-4,
                           dt_bwd=float(rng.uniform(4e-3, 1.2e-2))))
    sched = ref_get_policy(policy)(
        RefRequest(cluster=cluster, jobs=jobs, horizon=100000))
    return sched, ref_simulate(cluster, jobs, sched.assignment)


@pytest.mark.parametrize("policy", ["sjf-bco", "ff"])
def test_sched_launch_schedule_equals_reference(policy, capsys):
    res = sched_launch.main(["--devices", "4", "--servers", "2", "--jobs",
                             "3", "--steps", "2", "--policy", policy,
                             "--device", "cpu"])
    out = capsys.readouterr().out
    sched, sim = _reference_schedule(4, 2, 3, policy, 0)
    got = [(int(j), [int(g) for g in ids])
           for j, ids in res["schedule"].assignment]
    want = [(int(j), [int(g) for g in ids]) for j, ids in sched.assignment]
    assert got == want
    assert res["sim"].makespan == sim.makespan
    assert res["sim"].avg_jct == sim.avg_jct
    assert sorted(res["losses"]) == [0, 1, 2]
    assert all(math.isfinite(x) for ls in res["losses"].values() for x in ls)
    assert "all 3 jobs executed on their assigned slices" in out


def test_sched_launch_runs_every_family_of_its_pool(capsys):
    """Six jobs: the pool's whisper-tiny, hymba-1.5b and deepseek-moe-16b
    train too (reduced), and the schedule is the reference's."""
    res = sched_launch.main(["--devices", "4", "--servers", "2", "--jobs",
                             "6", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    sched, sim = _reference_schedule(4, 2, 6, "sjf-bco", 0)
    got = [(int(j), [int(g) for g in ids])
           for j, ids in res["schedule"].assignment]
    assert got == [(int(j), [int(g) for g in ids])
                   for j, ids in sched.assignment]
    for f in ("start", "finish", "makespan", "avg_jct"):
        assert np.array_equal(getattr(res["sim"], f), getattr(sim, f))
    assert sorted(res["losses"]) == list(range(6))
    assert all(len(ls) == 2 and all(math.isfinite(x) for x in ls)
               for ls in res["losses"].values())
    for arch in sched_launch.ARCH_POOL:
        assert f"({arch:18s} w=" in out
    assert "all 6 jobs executed on their assigned slices" in out


def test_launchers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sched_launch.main(["--jobs", "1", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_batch(configs.get_config("llama3.2-1b"),
                   InputShape("t", 8, 1, "train"), 0)
