"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 32B active (paper-table).

Source: Kimi K2 [arXiv:2501.kimi2].
61L, d_model=7168, 64 heads (GQA kv=8, head_dim 128), vocab=163840.
MoE: 384 routed experts (d_expert=2048, top-8) + 1 shared expert; first
layer dense (d_ff=18432), per the K2 card.

bf16 params + remat (1T fp32 would be 4 TB); fp32 Adam moments shard over
the full mesh.  Expert-parallel over ``model`` axis: 384 experts / 16 = 24
experts per device column.

Shape skip: long_500k skipped — full attention (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab=163_840,
    mlp="swiglu",
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    d_expert=2048,
    n_dense_layers=1,
    dense_d_ff=18432,
    rope="full",
    rope_theta=5.0e4,
    param_dtype="bfloat16",
    source="arXiv:2501.kimi2",
)
