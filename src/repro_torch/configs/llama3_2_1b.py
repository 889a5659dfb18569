"""llama3.2-1b [dense] — small llama3.

Source: hf:meta-llama/Llama-3.2-1B (model card).
16L, d_model=2048, 32 heads (GQA kv=8, head_dim 64), d_ff=8192 (SwiGLU),
vocab=128256, rope theta 500k, tied embeddings.

Shape skip: long_500k skipped — pure full attention (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=128_256,
    mlp="swiglu",
    rope="full",
    rope_theta=5.0e5,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
