"""xLSTM language model (sLSTM + mLSTM blocks) -- arXiv:2405.04517.

The port of ``repro/models/xlstm.py``.  The stack is organised in
super-blocks of ``slstm_every`` layers: (slstm_every - 1) mLSTM blocks
followed by one sLSTM block, ``G = n_layers // slstm_every`` groups.  The
parameter tree keeps the reference's names and stacked layout: leaves
under ``"mlstm"`` are ``[G, n_m, ...]``, leaves under ``"slstm"`` are
``[G, ...]``; the reference scans over those dims, the port loops.

Decode state is sequence-length independent (matrix memory C/n/m per
mLSTM block, scalar memories c/n/h/m per sLSTM block, stacked the same
way): there is no KV cache, and ``max_slots`` of ``init_cache`` is unused.
Prefill runs the mLSTM parallel form, through the K6 kernel when
``cfg.use_flash_kernel`` is set.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dtype_of, embed, generator,
                                       softmax_cross_entropy)
from repro_torch.models.ssm import (init_mlstm, init_mlstm_state, init_slstm,
                                    init_slstm_state, mlstm_seq, mlstm_step,
                                    slstm_seq, slstm_step)
from repro_torch.models.transformer import (_init_common, _layer,
                                            _public_logits, _unembed,
                                            maybe_remat)


def build_xlstm(cfg: ModelConfig, max_seq: int, device: torch.device):
    """The five model functions of an xlstm config on ``device``.
    ``max_seq`` is unused: the family is length-agnostic."""
    dtype = dtype_of(cfg.param_dtype)
    k = cfg.slstm_every
    if k <= 0 or cfg.n_layers % k:
        raise ValueError("xlstm needs slstm_every | n_layers")
    G, n_m = cfg.n_layers // k, k - 1

    def init(seed: int):
        """Random params from a torch.Generator on ``device`` seeded with
        ``seed``, at the reference's scales (not its bits)."""
        gen = generator(device, seed)
        p = _init_common(gen, cfg, dtype)
        p["mlstm"] = init_mlstm(gen, cfg, dtype, lead=(G, n_m))
        p["slstm"] = init_slstm(gen, cfg, dtype, lead=(G,))
        return p

    def _forward(params, batch):
        cd = dtype_of(cfg.compute_dtype)
        x = embed(params["embed"], batch["tokens"]).to(cd)
        group = maybe_remat(_group_seq, cfg, x)
        for g in range(G):
            x = group(_layer(params["mlstm"], g), _layer(params["slstm"], g),
                      x)
        return _unembed(params, cfg, x)

    def _group_seq(mp, sp, x):
        """One super-block: the n_m mLSTM blocks, then the sLSTM block."""
        for j in range(n_m):
            x = mlstm_seq(cfg, _layer(mp, j), x)
        return slstm_seq(cfg, sp, x)

    def loss_fn(params, batch):
        logits = _forward(params, batch)
        tokens = batch["tokens"]
        loss = softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
        return loss, {"loss": loss, "aux": torch.zeros_like(loss)}

    def prefill(params, batch):
        return _public_logits(cfg, _forward(params, batch))

    def init_cache(batch_size: int, max_slots: int):
        return {"mlstm": init_mlstm_state(cfg, batch_size, device,
                                          lead=(G, n_m)),
                "slstm": init_slstm_state(cfg, batch_size, device,
                                          lead=(G,))}

    def _write(stacked: dict, new: dict) -> None:
        for key, val in new.items():
            dst = stacked[key]
            if isinstance(dst, DTensor):     # in place: keep dst's placement
                val = val.redistribute(dst.device_mesh, dst.placements)
            dst.copy_(val)

    def decode_step(params, cache, tok, pos):
        """One token through every block; writes each block's slice of the
        stacked state in place (as the dense KV cache is) and returns the
        same cache.  ``pos`` is unused: the state carries the position."""
        cd = dtype_of(cfg.compute_dtype)
        x = embed(params["embed"], tok).to(cd)                # [B, d]
        for g in range(G):
            mp, ms = _layer(params["mlstm"], g), _layer(cache["mlstm"], g)
            for j in range(n_m):
                st = _layer(ms, j)
                x, new = mlstm_step(cfg, _layer(mp, j), st, x)
                _write(st, new)
            st = _layer(cache["slstm"], g)
            x, new = slstm_step(cfg, _layer(params["slstm"], g), st, x)
            _write(st, new)
        logits = _public_logits(cfg, _unembed(params, cfg, x[:, None, :]))
        return logits[:, 0], cache

    return init, loss_fn, prefill, init_cache, decode_step
