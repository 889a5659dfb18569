"""whisper-tiny [audio] — encoder-decoder with a stubbed conv/mel frontend.

Source: Whisper [arXiv:2212.04356].
4 decoder layers + 4 encoder layers, d_model=384, 6 heads (kv=6, head_dim
64), d_ff=1536 (GELU MLP), vocab=51865, learned decoder positions,
sinusoidal encoder positions, 1500 encoder frames.

Frontend stub (the one allowed carve-out): ``input_specs()`` provides
precomputed 1500-frame encoder embeddings of shape [B, 1500, 384]; the
mel-spectrogram + 2xConv1d feature extractor is NOT implemented.

Shape skips (DESIGN.md): long_500k skipped — the full-attention decoder has
no sub-quadratic variant and a 500k text context is outside this family's
scope.  train_4k/decode_32k exercise the decoder at the assigned lengths
(structurally longer than Whisper's 448-token context; documented).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51_865,
    mlp="gelu",
    rope="none",
    learned_pos=True,
    enc_frames=1500,
    source="arXiv:2212.04356",
)
