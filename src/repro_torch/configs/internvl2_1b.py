"""internvl2-1b [vlm] — InternViT frontend (stub) + InternLM2/Qwen2-style
decoder backbone.

Source: InternVL 1.5/2 [arXiv:2404.16821].
24L, d_model=896, 14 heads (GQA kv=2, head_dim 64), d_ff=4864 (SwiGLU),
vocab=151655, 256 image-patch tokens prepended.

Frontend stub (the one allowed carve-out): ``input_specs()`` provides
precomputed patch embeddings [B, 256, 896]; the InternViT vision tower is
NOT implemented — only the MLP projector + language decoder that consume
its output.

Shape skip: long_500k skipped — pure full attention (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151_655,
    mlp="swiglu",
    rope="full",
    rope_theta=1.0e6,
    n_patches=256,
    tie_embeddings=True,
    source="arXiv:2404.16821",
)
