"""hymba-1.5b [hybrid] — parallel attention + Mamba heads in every block.

Source: Hymba [arXiv:2411.13676].
32L, d_model=1600, 25 heads (GQA kv=5, head_dim 64), d_ff=5504,
vocab=32001, ssm_state=16.  Attention is sliding-window (1024) everywhere
except the first / middle / last layers, which stay global — Hymba's
meta-token mechanism is omitted (not part of the assigned config).

long_500k runs: the Mamba branch is O(1)/token and the attention branch
rolls a window-sized cache, so decode state is bounded.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32_001,
    mlp="swiglu",
    window=1024,
    ssm_state=16,
    ssm_heads=25,
    ssm_head_dim=64,
    rope="full",
    source="arXiv:2411.13676",
)
