"""The sLSTM scan as one op on fake tensors, held to the loop it stands
for; the plain paths of the sLSTM and of the Mamba decode head.

``repro_torch::slstm_scan`` (``models/slstm_scan.py``) stands for the
sLSTM loop when the dry-run runs it on fake tensors.  Here it is held to
the loop it replaces, run on the same fake inputs under the same
counters:

  * FLOPs and bytes (``roofline.CostCounter``) equal exactly, forward and
    forward + backward, at reduced and at xlstm-350m widths, for every
    combination of inputs that take a gradient and for a bf16 ``r_h``;
  * the peak (``roofline.PeakMemory``) within 5%.

Plain tensors never reach the op: ``slstm_seq`` and ``mamba_step`` give
the bits of the loop and of the inline head they had.  The whole dry-run
step with the op, and hymba's decode with the Mamba head per shard, are
held on the fake mesh in ``test_torch_dryrun.py`` (which shares DTensor's
warm sharding caches with them).  Everything runs on the CPU; the
reference-parity tests of these functions are in ``test_torch_xlstm.py``
and ``test_torch_hybrid.py``.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.launch import roofline
from repro_torch.models import ssm
from repro_torch.models.layers import generator
from repro_torch.models.slstm_scan import scan_op, slstm_scan

WIDTHS = {"reduced": configs.get_config("xlstm-350m").reduced(),
          "xlstm-350m": configs.get_config("xlstm-350m")}


def _counted(fn, cfg, B, S, *, train, gx_dtype, r_dtype=torch.float32,
             grads=(True, True)):
    """(FLOPs, bytes, peak bytes) of ``fn(r_h, gx)`` -- and of autograd's
    gradient of its output when ``train`` -- on fake tensors under the
    dry-run's counters."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    H, d = cfg.n_heads, cfg.d_model
    dh = d // H
    with mode:
        r_h = torch.randn(H, dh, 4 * dh, dtype=r_dtype,
                          requires_grad=train and grads[0])
        gx = torch.randn(B, S, 4 * d, dtype=gx_dtype,
                         requires_grad=train and grads[1])
        grad_h = torch.randn(B, S, H, dh)
    counter = roofline.CostCounter(fake_mode=mode)
    peak = roofline.PeakMemory([r_h, gx, grad_h], mode)
    with counter, peak, torch.set_grad_enabled(train):
        if train:
            wrt = [t for t in (r_h, gx) if t.requires_grad]
            torch.autograd.grad(fn(r_h, gx), wrt, grad_h)
        else:
            fn(r_h, gx)
    return counter.flops, counter.bytes, peak.peak


def _same_counts(cfg, B, S, **kw):
    loop = _counted(lambda r, g: ssm._slstm_loop(cfg, r, g), cfg, B, S, **kw)
    op = _counted(slstm_scan, cfg, B, S, **kw)
    assert op[0] == loop[0] > 0
    assert op[1] == loop[1] > 0
    return op[2], loop[2]


@pytest.mark.parametrize("train", [False, True], ids=["fwd", "fwd+bwd"])
@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_op_counts_equal_the_loop(width, B, S, train):
    """The dry-run's case: r_h (a param) and gx (an activation) both take
    a gradient; gx in the config's compute dtype."""
    cfg = WIDTHS[width]
    op_peak, loop_peak = _same_counts(
        cfg, B, S, train=train, gx_dtype=getattr(torch, cfg.compute_dtype))
    assert abs(op_peak - loop_peak) <= 0.05 * loop_peak


@pytest.mark.parametrize("grads", [(True, False), (False, True)],
                         ids=["r_h-only", "gx-only"])
@pytest.mark.parametrize("r_dtype", [torch.float32, torch.bfloat16])
def test_op_counts_with_one_gradient_and_a_bf16_r_h(grads, r_dtype):
    cfg = WIDTHS["reduced"]
    op_peak, loop_peak = _same_counts(cfg, 3, 16, train=True,
                                      gx_dtype=torch.bfloat16,
                                      r_dtype=r_dtype, grads=grads)
    assert abs(op_peak - loop_peak) <= 0.05 * loop_peak


@pytest.mark.parametrize("S", [1, 2])
def test_op_counts_at_the_shortest_scans(S):
    """One step is both the first and the last; two have one link."""
    for train in (False, True):
        _same_counts(WIDTHS["reduced"], 2, S, train=train,
                     gx_dtype=torch.float32)


def test_op_has_no_kernel_for_real_tensors():
    """Fake tensors only: a real tensor finds no kernel."""
    r_h, gx = torch.zeros(2, 4, 16), torch.zeros(1, 3, 32)
    with pytest.raises(NotImplementedError):
        scan_op(r_h, gx, False, False)


def _slstm_case(seed=3):
    cfg = WIDTHS["reduced"]
    p = ssm.init_slstm(generator(torch.device("cpu"), seed), cfg,
                       torch.float32)
    x = torch.tensor(np.random.default_rng(seed).standard_normal(
        (2, 24, cfg.d_model)), dtype=torch.float32)
    return cfg, p, x


def test_plain_slstm_seq_keeps_the_loop_bits():
    """slstm_seq on plain tensors is the loop: output and gradients."""
    cfg, p, x = _slstm_case()
    outs = []
    for run in ("seq", "loop"):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xi = x.clone().requires_grad_()
        if run == "seq":
            y = ssm.slstm_seq(cfg, leaves, xi)
        else:
            gx = ssm.rms_norm(xi, leaves["norm"], cfg.norm_eps) \
                @ leaves["w_x"]
            y = ssm._slstm_out(leaves, xi, ssm._slstm_loop(
                cfg, leaves["r_h"], gx))
        y.square().sum().backward()
        outs.append([y, xi.grad] + [leaves[k].grad for k in sorted(leaves)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _mamba_step_inline(cfg, p, state, x_t):
    """``mamba_step`` as it was with the head inline (before the head
    became ``_mamba_head``)."""
    cd = x_t.dtype
    B, d = x_t.shape
    Hs, P = cfg.ssm_heads, cfg.ssm_head_dim
    inner = Hs * P
    uz = x_t @ p["w_in"].to(cd)
    u, z = uz[..., :inner], uz[..., inner:]
    hist = torch.cat([state["conv"], u[:, None, :]], dim=1)
    u_c = sum(hist[:, i] * p["w_conv"][i].to(cd) for i in range(ssm._CONV_K))
    u_c = ssm._silu(u_c).reshape(B, Hs, P)
    a, b = ssm._mamba_gates(cfg, p, u_c)
    h = a.float() * state["h"] + b
    C = torch.einsum("bhp,hpn->bhn", *ssm._promoted(u_c, p["w_C"])).float()
    y = torch.einsum("bhpn,bhn->bhp", h, C).to(cd) + p["D"].to(cd) * u_c
    y = (y.reshape(B, inner) * ssm._silu(z)) @ p["w_out"].to(cd)
    return y, {"h": h, "conv": hist[:, 1:]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_mamba_step_keeps_its_bits(dtype):
    cfg = configs.get_config("hymba-1.5b").reduced()
    p = ssm.init_mamba(generator(torch.device("cpu"), 5), cfg, dtype)
    rng = np.random.default_rng(5)
    state = ssm.init_mamba_state(cfg, 3, dtype, "cpu")
    state["h"] = torch.tensor(rng.standard_normal(state["h"].shape),
                              dtype=torch.float32)
    for t in range(3):
        x_t = torch.tensor(rng.standard_normal((3, cfg.d_model)),
                           dtype=dtype)
        got, new = ssm.mamba_step(cfg, p, state, x_t)
        want, old = _mamba_step_inline(cfg, p, state, x_t)
        assert torch.equal(got, want)
        assert all(torch.equal(new[k], old[k]) for k in old)
        state = new
