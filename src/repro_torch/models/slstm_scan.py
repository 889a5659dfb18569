"""The sLSTM recurrence as one registered op on fake tensors: how the
dry-run prices a scan over S positions.

``ssm._slstm_loop`` runs the cell once a position, a dozen small ops a
step.  On the fake tensors of the dry-run (``launch/dryrun.py``) each of
those ops goes through ``FakeTensorMode`` and three dispatch modes, and
at S = 4096 or 32768 positions a dry-run step does not finish.  The
reference prices its one ``lax.scan`` as one body times the trip count
(``loop_cost_correction`` in ``repro/launch/roofline.py``); this module
is the port's counterpart for that loop.

``repro_torch::slstm_scan`` stands for the whole loop and
``repro_torch::slstm_scan_backward`` for its whole backward.  Both have a
fake implementation only: they make the outputs' metadata and nothing
else, and a real tensor that reached them would find no kernel.  Plain
tensors keep the loop (``ssm.slstm_seq``).

What the counters see is written out here from the cell's ops
(``ssm._slstm_cell``), never measured:

* :func:`scan_flops` / :func:`backward_flops` -- the loop's matrix
  products (the only ops ``torch.utils.flop_counter`` prices): one
  [H, B, dh] x [H, dh, 4dh] product a step forward, and in the backward
  one for ``r_h``'s gradient a step and one for the previous ``h``'s a
  step but the first;
* :func:`scan_bytes` / :func:`backward_bytes` -- every operand read once
  and every output written once, op by op, as ``roofline.CostCounter``
  counts the loop, autograd's gradient sums included;
* the memory ``roofline.PeakMemory`` sees: the forward returns the
  stacked ``h`` and, when autograd records, one byte tensor as large as
  the residuals autograd saves in the loop's steps (kept alive until the
  backward, freed by it); :func:`scan_workspace` and
  :func:`backward_workspace` are what the loop holds only while it runs
  (the list of step outputs before the stack, the gradient sums).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

torch.library.define(
    "repro_torch::slstm_scan",
    "(Tensor r_h, Tensor gx, bool grad_r_h, bool grad_gx) "
    "-> (Tensor, Tensor)")
torch.library.define(
    "repro_torch::slstm_scan_backward",
    "(Tensor grad_h, Tensor r_h, Tensor saved, ScalarType gx_dtype, "
    "bool grad_r_h, bool grad_gx) -> (Tensor, Tensor)")

scan_op = torch.ops.repro_torch.slstm_scan.default
backward_op = torch.ops.repro_torch.slstm_scan_backward.default

_F32 = 4     # bytes of a float32 element


def _dims(r_h, h_or_gx) -> tuple:
    """(B, S, H, dh) of the scan of r_h [H, dh, 4dh] over [B, S, ...]."""
    H, dh = r_h.shape[0], r_h.shape[1]
    return h_or_gx.shape[0], h_or_gx.shape[1], H, dh


def _logsig_buffer(u: int, device) -> int:
    """Bytes of ``log_sigmoid_forward``'s second output: a copy of the
    input on the CPU, empty on CUDA."""
    return 0 if torch.device(device).type in ("cuda", "xpu") else u * _F32


def _step_saved(u: int, er: int, device, grad_r_h: bool) -> int:
    """Bytes autograd keeps from one step of the loop for its backward:
    the gate pre-activations g [B, H, 4dh], the ``log_sigmoid`` buffer,
    logf + m, i_s, f_s, tanh(z), c, n, sigmoid(o), sigmoid(o) * c and
    n.clamp_min(1) (each [B, H, dh] f32), plus the previous h the step's
    product read (in r_h's dtype) when r_h takes a gradient."""
    return 13 * u * _F32 + _logsig_buffer(u, device) \
        + (u * er if grad_r_h else 0)


def saved_bytes(B, S, H, dh, er, device, grad_r_h: bool) -> int:
    """Bytes autograd keeps from the loop's forward: S steps' and the
    initial c and n."""
    u = B * H * dh
    return S * _step_saved(u, er, device, grad_r_h) + 2 * u * _F32


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def scan_flops(r_h_shape, gx_shape, *args, **kwargs) -> int:
    """S products [H, B, dh] x [H, dh, 4dh]."""
    H, dh, dh4 = r_h_shape
    B, S = gx_shape[:2]
    return S * 2 * H * B * dh * dh4


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def backward_flops(grad_h_shape, r_h_shape, saved_shape, gx_dtype,
                   grad_r_h, grad_gx, *args, **kwargs) -> int:
    """r_h's gradient a step, the previous h's a step but the first."""
    H, dh, dh4 = r_h_shape
    B, S = grad_h_shape[:2]
    return ((S if grad_r_h else 0) + S - 1) * 2 * H * B * dh * dh4


def scan_bytes(r_h, gx, grad_r_h, grad_gx, out_val=None) -> int:
    """The loop's forward, op by op: the initial state (three zeros and a
    full), then a step -- h.to(r_h's dtype) where that is not f32, the
    product, rh.float(), gx_t.float() where gx is not f32, g = gx_t + rh
    over [B, H, 4dh]; then over [B, H, dh] f32 log_sigmoid (its output
    and buffer), twelve binary ops (logf + m twice, the max, two subs,
    five muls, two adds, the div) and five unary ones (two exps, tanh,
    sigmoid, clamp_min) -- and the stack of the S outputs."""
    B, S, H, dh = _dims(r_h, gx)
    u, F = B * H * dh, B * H * dh * _F32
    er, eg = r_h.element_size(), gx.element_size()
    step = (u * er + r_h.numel() * er + 4 * u * er) \
        + 12 * F + 2 * F + _logsig_buffer(u, gx.device) \
        + 12 * 3 * F + 5 * 2 * F
    if er != _F32:
        step += (F + u * er) + (4 * u * er + 4 * F)
    if eg != _F32:
        step += 4 * u * eg + 4 * F
    return 4 * F + S * (step + 2 * F)


def backward_bytes(grad_h, r_h, saved, gx_dtype, grad_r_h, grad_gx,
                   out_val=None) -> int:
    """The loop's backward as autograd runs it, op by op.

    Every step ("core"): the div's backward (three divs, a neg, a mul),
    clamp_min's (a scalar, a >= mask, a where), the maximum's (for each
    side a halving div, an == mask, a where, a < or > mask and an
    in-place masked fill), eight muls, sigmoid's, tanh's and
    log_sigmoid's backward, two negs (the subs), five gradient sums
    (i_s, f_s, the two uses of m_new, i_pre, logf) and the cat of the
    four gate gradients; rh.float()'s backward where r_h is not f32; the
    product for r_h's gradient when it takes one; gx_t.float()'s backward
    where gx is not f32 and gx's select backward (a zero [B, S, 4d]) when
    gx takes a gradient.

    Every step but the first ("link", where the previous state takes a
    gradient): two muls (c and n), the product for h's gradient and its
    cast back to f32 where r_h is not f32, and four sums (m twice, c, n,
    h: each state tensor's gradient from its own step and from the next).

    And the S - 1 sums of r_h's and of gx's gradients, at their full
    size."""
    B, S, H, dh = _dims(r_h, grad_h)
    u, F = B * H * dh, B * H * dh * _F32
    er = r_h.element_size()
    eg = torch.empty((), dtype=gx_dtype).element_size()
    bmm = u * er + r_h.numel() * er + 4 * u * er
    core = (3 * 3 * F + 2 * F + 3 * F) \
        + (_F32 + (F + u) + (u + 2 * F + _F32)) \
        + 2 * (2 * F + (2 * F + u) + (3 * F + u) + 2 * (2 * F + u)) \
        + 8 * 3 * F \
        + 3 * F + 3 * F + 3 * F + _logsig_buffer(u, grad_h.device) \
        + 2 * 2 * F + 5 * 3 * F + 2 * 4 * F
    #     div; clamp_min (bool masks of u bytes, a scalar); maximum;
    #     muls; sigmoid, tanh, log_sigmoid backward; negs; sums; cat
    link = 2 * 3 * F + bmm + 4 * 3 * F + 3 * F
    if er != _F32:
        link += u * er + F
    if grad_r_h:
        core += bmm
    gx_bytes = S * 4 * u * eg
    if grad_gx:
        core += 4 * u * eg + gx_bytes
        if eg != _F32:
            core += 4 * F + 4 * u * eg
    total = S * core + (S - 1) * link
    if er != _F32:        # rh's grad, but the first step's without r_h's
        total += (S if grad_r_h else S - 1) * (4 * F + 4 * u * er)
    if grad_r_h:
        total += (S - 1) * 3 * r_h.numel() * er
    if grad_gx:
        total += (S - 1) * 3 * gx_bytes
    return total


def scan_workspace(r_h, gx, grad_r_h, grad_gx, out_val=None) -> int:
    """Bytes the loop holds above its outputs while it runs: its list of
    the S step outputs before the stack, and the last c, n and m."""
    B, S, H, dh = _dims(r_h, gx)
    return (S + 3) * B * H * dh * _F32


def backward_workspace(grad_h, r_h, saved, gx_dtype, grad_r_h, grad_gx,
                       out_val=None) -> int:
    """Bytes the loop's backward holds above the two gradients and the
    residuals: at each sum of r_h's or gx's gradient, the new term and
    the sum beside the old one -- from the second step from the end on,
    when the last step's residuals are gone."""
    B, S, H, dh = _dims(r_h, grad_h)
    eg = torch.empty((), dtype=gx_dtype).element_size()
    sums = 2 * max(r_h.numel() * r_h.element_size() if grad_r_h else 0,
                   S * 4 * B * H * dh * eg if grad_gx else 0)
    return max(0, sums - _step_saved(B * H * dh, r_h.element_size(),
                                     grad_h.device, grad_r_h))


@torch.library.register_fake("repro_torch::slstm_scan")
def _scan_fake(r_h, gx, grad_r_h, grad_gx):
    B, S, H, dh = _dims(r_h, gx)
    n = saved_bytes(B, S, H, dh, r_h.element_size(), gx.device, grad_r_h) \
        if grad_r_h or grad_gx else 0
    return (gx.new_empty((B, S, H, dh), dtype=torch.float32),
            gx.new_empty((n,), dtype=torch.uint8))


@torch.library.register_fake("repro_torch::slstm_scan_backward")
def _backward_fake(grad_h, r_h, saved, gx_dtype, grad_r_h, grad_gx):
    B, S, H, dh = _dims(r_h, grad_h)
    return (r_h.new_empty(r_h.shape if grad_r_h else (0,)),
            grad_h.new_empty((B, S, 4 * H * dh) if grad_gx else (0,),
                             dtype=gx_dtype))


def _setup(ctx, inputs, output):
    r_h, gx, grad_r_h, grad_gx = inputs
    ctx.set_materialize_grads(False)   # no zeros for the residuals' grad
    ctx.save_for_backward(r_h, output[1])
    ctx.gx_dtype = gx.dtype
    ctx.grads = (grad_r_h, grad_gx)


def _backward(ctx, grad_h, _grad_saved):
    r_h, saved = ctx.saved_tensors
    g_r, g_x = backward_op(grad_h, r_h, saved, ctx.gx_dtype, *ctx.grads)
    return (g_r if ctx.grads[0] else None, g_x if ctx.grads[1] else None,
            None, None)


torch.library.register_autograd("repro_torch::slstm_scan", _backward,
                                setup_context=_setup)


def slstm_scan(r_h: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """h [B, S, H, dh] of the sLSTM over gx [B, S, 4d] with the recurrent
    weights r_h, on fake tensors only (the shapes and costs of
    ``ssm._slstm_loop``)."""
    record = torch.is_grad_enabled()
    h, _ = scan_op(r_h, gx, record and r_h.requires_grad,
                   record and gx.requires_grad)
    return h
