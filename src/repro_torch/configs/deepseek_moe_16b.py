"""deepseek-moe-16b [moe] — fine-grained expert segmentation + shared experts.

Source: DeepSeekMoE [arXiv:2401.06066].
28L, d_model=2048, 16 heads (kv=16, head_dim 128), vocab=102400.
MoE: 64 routed experts (d_expert=1408, top-6) + 2 shared experts; the first
layer is a dense FFN (d_ff=10944), per the released model.

Expert-parallel: the expert dim of [E, d, d_e] weights shards over the
``model`` mesh axis; dispatch/combine lower to all-to-all-class collectives.

Shape skip: long_500k skipped — pure full attention (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab=102_400,
    mlp="swiglu",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_expert=1408,
    n_dense_layers=1,
    dense_d_ff=10944,
    rope="full",
    source="arXiv:2401.06066",
)
