"""Batched serving: prefill a prompt batch, then decode greedily.

The port of ``repro/launch/serve.py``: the same CLI and loop, on the card
unless ``--device cpu`` is given::

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama3.2-1b --reduced --batch 4 --prompt-len 16 --gen 32

An audio arch (whisper-tiny) gets seeded frame embeddings, which its
encoder turns into the cross-attention input once.

Seconds are host wall time around work that ends in
``torch.cuda.synchronize()`` (on a CUDA device).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.dist.steps import make_serve_step
from repro_torch.models import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(model, params, prompt: torch.Tensor, gen: int,
               frames: torch.Tensor | None = None) -> dict:
    """Step ``prompt`` [B, P] (int32, on the model's device) through the
    cache, then decode ``gen`` tokens greedily.

    Prefill steps the prompt through the decode path (one code path for
    recurrent and attention families alike), as the reference does.  An
    audio model first runs its encoder once over ``frames`` [B, F, d] and
    pins the output into the cache (outside the timed prefill, as there).
    Returns ``tokens`` [B, gen] (int32, on the device), the last step's
    ``logits`` [B, vocab], and ``prefill_s`` / ``decode_s``."""
    B, P = prompt.shape
    dev = model.device
    serve = make_serve_step(model)
    cache = model.init_cache(B, P + gen)
    if frames is not None:
        cache["enc_out"] = model.encode(params, frames)

    def at(pos):
        return torch.full((B,), pos, dtype=torch.int32, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    for pos in range(P - 1):
        _, _, cache = serve(params, cache, prompt[:, pos], at(pos))
    tok = prompt[:, -1]
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = []
    logits = None
    t0 = time.perf_counter()
    for i in range(gen):
        tok, logits, cache = serve(params, cache, tok, at(P - 1 + i))
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(out, dim=1), "logits": logits,
            "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "vlm":
        raise SystemExit("vlm serving needs patch inputs; use examples/")
    max_seq = args.prompt_len + args.gen
    model = build_model(cfg, max_seq=max_seq, device=args.device)
    params = model.init(0)

    B = args.batch
    rng = np.random.default_rng(0)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (B, args.prompt_len)),
                          dtype=torch.int32, device=model.device)
    frames = None
    if cfg.family == "audio":
        frames = torch.tensor(
            rng.standard_normal((B, cfg.enc_frames, cfg.d_model)),
            dtype=torch.float32, device=model.device)
    res = serve_loop(model, params, prompt, args.gen, frames)
    gen = res["tokens"].cpu().numpy()
    gen_t = res["decode_s"]
    print(f"[serve] {cfg.name}: batch {B}, prompt {args.prompt_len}, "
          f"generated {args.gen} tokens/seq")
    print(f"[serve] prefill {res['prefill_s']:.2f}s, decode {gen_t:.2f}s "
          f"({B*args.gen/max(gen_t,1e-9):.1f} tok/s)")
    print(f"[serve] sample tokens (seq 0): {gen[0][:16].tolist()}")
    assert np.all(gen >= 0) and np.all(gen < cfg.vocab)
    return res


if __name__ == "__main__":
    main()
