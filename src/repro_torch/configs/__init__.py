"""Architecture registry: the 10 assigned configs + shape support matrix.

The port's copy of ``repro/configs/__init__.py`` (data only).
``get_config(arch)`` returns the exact assigned ModelConfig;
``input_specs(cfg, shape)`` returns ``meta``-device stand-ins (the
counterpart of ``jax.ShapeDtypeStruct``) for every model input of that
(arch, shape) pair: allocation-free, with the reference's keys, shapes and
dtypes (the dry-run builds its inputs from these);
``supported_shapes(cfg)`` applies the DESIGN.md skip rules (long_500k only
for sub-quadratic-decode families).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.chatglm3_6b import CONFIG as CHATGLM3_6B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.llama3_405b import CONFIG as LLAMA3_405B
from repro_torch.configs.llama3_2_1b import CONFIG as LLAMA3_2_1B
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.internvl2_1b import CONFIG as INTERNVL2_1B
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as KIMI_K2

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        GEMMA2_9B, WHISPER_TINY, CHATGLM3_6B, HYMBA_1_5B, LLAMA3_405B,
        LLAMA3_2_1B, XLSTM_350M, INTERNVL2_1B, DEEPSEEK_MOE_16B, KIMI_K2,
    )
}

# long_500k support: SSM/hybrid (O(1) decode state) + gemma2's documented
# sliding-window variant.  All other archs are pure full attention — skipped
# per DESIGN.md §Arch-applicability.
LONG_CONTEXT_OK = {"xlstm-350m", "hymba-1.5b", "gemma2-9b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def supported_shapes(cfg: ModelConfig) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.name in LONG_CONTEXT_OK:
        names.append("long_500k")
    return names


def cache_slots(cfg: ModelConfig, shape: InputShape) -> int:
    """KV-cache slot count for a decode shape.  long_500k rolls a
    window-sized cache (sliding-window serving); decode_32k keeps the full
    context."""
    if shape.name == "long_500k" and cfg.window:
        return cfg.window
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                batch_override: int | None = None, device="meta") -> dict:
    """Stand-ins for the model inputs of (cfg, shape), on ``device``
    (``meta`` by default: shapes and dtypes only, nothing allocated).

    train/prefill -> the batch dict consumed by loss_fn/prefill;
    decode       -> {"tok": [B], "pos": [B]} (the cache is built separately
    via Model.init_cache)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    if shape.is_decode:
        return {"tok": sds((B,), i32), "pos": sds((B,), i32)}
    if cfg.family == "vlm":
        return {"tokens": sds((B, S - cfg.n_patches), i32),
                "patches": sds((B, cfg.n_patches, cfg.d_model), f32)}
    if cfg.family == "audio":
        return {"frames": sds((B, cfg.enc_frames, cfg.d_model), f32),
                "tokens": sds((B, S), i32)}
    return {"tokens": sds((B, S), i32)}


__all__ = ["ARCHS", "LONG_CONTEXT_OK", "get_config", "supported_shapes",
           "cache_slots", "input_specs", "INPUT_SHAPES"]
