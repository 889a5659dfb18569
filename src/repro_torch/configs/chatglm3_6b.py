"""chatglm3-6b [dense] — 2d RoPE (half-dim rotation), extreme GQA (kv=2).

Source: ChatGLM family report [arXiv:2406.12793].
28L, d_model=4096, 32 heads (GQA kv=2, head_dim 128), d_ff=13696 (SwiGLU),
vocab=65024.

Shape skip: long_500k skipped — pure full attention (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65_024,
    mlp="swiglu",
    rope="half",                     # GLM 2d rope: only half the head dim rotates
    rope_theta=1.0e4,
    source="arXiv:2406.12793",
)
