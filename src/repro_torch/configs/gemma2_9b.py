"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.

Source: Gemma 2 technical report [arXiv:2408.00118].
42L, d_model=3584, 16 heads (GQA kv=8, head_dim 256), d_ff=14336 (GeGLU),
vocab=256000, sliding window 4096 on local layers, attn softcap 50.0,
final softcap 30.0, tied embeddings.

long_500k note (DESIGN.md §Arch-applicability): served in the
sliding-window variant — the rolling KV cache holds the last ``window``
positions, so global layers also attend within the window.  This is the
documented deviation that makes the long-context decode shape sub-quadratic
(in cache memory) for this otherwise full-attention arch.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256_000,
    mlp="geglu",
    layer_pattern="local_global",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope="full",
    rope_theta=1.0e4,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
