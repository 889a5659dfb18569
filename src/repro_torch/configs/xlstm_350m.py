"""xlstm-350m [ssm] — sLSTM + mLSTM blocks, no attention, no KV cache.

Source: xLSTM [arXiv:2405.04517].
24L, d_model=1024, 4 heads, vocab=50304 (GPT-NeoX tokenizer), d_ff=0 (the
feed-forward lives inside the LSTM blocks: mLSTM up-projection factor 2,
sLSTM post-MLP factor 4/3).  Block mix: 3 mLSTM : 1 sLSTM per super-block
(slstm_every=4 -> 18 mLSTM + 6 sLSTM), following the paper's
mostly-mLSTM recipe at this scale; head_dim = proj_factor*d / heads = 512.

long_500k runs: recurrent state is sequence-length independent.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,                    # mLSTM head dim = (pf * d) / heads
    d_ff=0,
    vocab=50_304,
    slstm_every=4,
    mlstm_proj_factor=2.0,
    rope="none",
    source="arXiv:2405.04517",
)
