"""llama3-405b [dense] — the frontier-scale dense config.

Source: The Llama 3 Herd of Models [arXiv:2407.21783].
126L, d_model=16384, 128 heads (GQA kv=8, head_dim 128), d_ff=53248
(SwiGLU), vocab=128256, rope theta 500k.

bf16 params + remat: at 405B params the fp32 master copy would not fit the
2 TB/pod HBM budget alongside Adam state; dist/optim shards fp32 moments
over the full mesh (ZeRO-3 style) and keeps bf16 params (documented in
DESIGN.md hardware-adaptation notes).

Shape skip: long_500k skipped — pure full attention (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128_256,
    mlp="swiglu",
    rope="full",
    rope_theta=5.0e5,
    param_dtype="bfloat16",
    source="arXiv:2407.21783",
)
