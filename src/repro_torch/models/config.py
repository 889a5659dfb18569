"""Model configuration shared by every assigned architecture.

The port's own copy of ``repro/models/config.py`` (a pure dataclass, kept
field for field).  One frozen dataclass covers the six arch families
(dense / moe / ssm / hybrid / vlm / audio); each
``repro_torch/configs/<id>.py`` instantiates it with the exact assigned
numbers and cites its source.  ``reduced()`` yields
the CPU-smoke variant (<=2 layers, d_model<=512, <=4 experts) required by
the per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- attention flavour ---------------------------------------------------
    rope: str = "full"                 # full|half|none (half = chatglm 2d rope)
    rope_theta: float = 1.0e4
    window: int = 0                    # sliding-window size for "local" layers
    layer_pattern: str = "global"      # "global" | "local_global" alternation
    attn_softcap: float = 0.0          # gemma2 attn-logit softcap (0 = off)
    final_softcap: float = 0.0         # gemma2 final-logit softcap (0 = off)
    learned_pos: bool = False          # whisper decoder absolute positions

    # --- mlp -------------------------------------------------------------------
    mlp: str = "swiglu"                # swiglu|geglu|gelu

    # --- moe -------------------------------------------------------------------
    n_experts: int = 0                 # routed experts
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                  # per-expert hidden dim
    n_dense_layers: int = 0            # leading dense layers (deepseek/kimi)
    dense_d_ff: int = 0                # their FFN width
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- ssm / hybrid -----------------------------------------------------------
    ssm_state: int = 0                 # N, per-head state size (mamba)
    ssm_heads: int = 0                 # parallel mamba heads (hymba)
    ssm_head_dim: int = 0
    slstm_every: int = 0               # xlstm: every k-th block is sLSTM
    mlstm_proj_factor: float = 2.0

    # --- enc-dec / modality stubs -----------------------------------------------
    n_enc_layers: int = 0
    enc_frames: int = 0                # audio: precomputed frame embeddings
    n_patches: int = 0                 # vlm: precomputed patch embeddings

    # --- norm / embedding / numerics ----------------------------------------------
    norm_eps: float = 1.0e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    use_flash_kernel: bool = False     # prefill attention through the K5
                                       # kernel (plain version on CPU)
    q_chunk: int = 512                 # query-chunked attention (0 = off):
                                       # never materialises the SxS matrix
    # --- §Perf hillclimb knobs (beyond-paper optimisations) -----------------
    seq_shard_blocks: bool = False     # Megatron-SP: shard the residual's
                                       # sequence axis over "model" between
                                       # blocks (norms/saves 1/16 the size)
    norm_cast_early: bool = False      # cast to compute dtype before the
                                       # norm's scale-mul so only bf16
                                       # crosses op/collective boundaries
    barrier_block_inputs: bool = False  # optimization_barrier on the bf16
                                        # matmul inputs: stops XLA hoisting
                                        # fp32 converts across collectives
    kv_cache_dtype: str = ""            # "" = compute dtype; "int8" halves
                                        # decode cache residency (quantised
                                        # with per-slot-head scales)

    source: str = ""                   # citation for the assigned config

    # ------------------------------------------------------------------------

    def __post_init__(self) -> None:
        if self.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
            raise ValueError(f"unknown family {self.family}")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads (GQA)")
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError("moe family needs n_experts and top_k")
        if self.layer_pattern not in ("global", "local_global"):
            raise ValueError(f"unknown layer_pattern {self.layer_pattern}")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def attn_param_count(self) -> int:
        d, h, k, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return d * h * hd + 2 * d * k * hd + h * hd * d

    def param_count(self) -> int:
        """Approximate total parameter count N (used for 6·N·D roofline)."""
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # xlstm
            n_s = self.n_layers // self.slstm_every if self.slstm_every else 0
            n_m = self.n_layers - n_s
            dk = self.head_dim
            m_blk = d * 2 * int(self.mlstm_proj_factor * d) \
                + 3 * int(self.mlstm_proj_factor * d) * self.n_heads * dk \
                + self.n_heads * dk * d
            s_blk = 4 * d * d + int(d * 4 / 3) * d * 2
            return emb + n_m * m_blk + n_s * s_blk
        per_layer = self.attn_param_count
        if self.family in ("moe",):
            moe_layers = self.n_layers - self.n_dense_layers
            ff_moe = 3 * d * self.d_expert * (self.n_experts + self.n_shared_experts) \
                + d * self.n_experts
            ff_dense = 3 * d * self.dense_d_ff
            ff_total = moe_layers * ff_moe + self.n_dense_layers * ff_dense
            return emb + self.n_layers * per_layer + ff_total
        gate = 2 if self.mlp in ("swiglu", "geglu") else 1
        ff = (gate + 1) * d * self.d_ff
        total = emb + self.n_layers * (per_layer + ff)
        if self.family == "hybrid":
            # mamba branch params per layer
            P, N, Hs = self.ssm_head_dim, self.ssm_state, self.ssm_heads
            inner = Hs * P
            total += self.n_layers * (2 * d * inner + inner * N * 2 + inner * d)
        if self.family == "audio":
            enc_ff = (1 + 1) * d * self.d_ff
            total += self.n_enc_layers * (per_layer + enc_ff)
            total += self.n_layers * per_layer  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        moe_layers = self.n_layers - self.n_dense_layers
        ff_act = 3 * d * self.d_expert * (self.top_k + self.n_shared_experts) \
            + d * self.n_experts
        ff_dense = 3 * d * self.dense_d_ff
        return emb + self.n_layers * self.attn_param_count \
            + moe_layers * ff_act + self.n_dense_layers * ff_dense

    def reduced(self) -> "ModelConfig":
        """Smoke variant: <=2 layers (x2 for pattern/super-blocks), small dims."""
        d = min(self.d_model, 256)
        hd = min(self.head_dim, 32)
        n_kv = min(self.n_kv_heads, 2)
        n_h = n_kv * min(self.q_per_kv, 2)
        layers = 2 if self.layer_pattern == "global" else 2
        if self.slstm_every:
            layers = max(2, min(self.slstm_every, 4))
        return dataclasses.replace(
            self,
            n_layers=layers,
            d_model=d,
            n_heads=n_h,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_expert=min(self.d_expert, 128) if self.d_expert else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            dense_d_ff=min(self.dense_d_ff, 256) if self.dense_d_ff else 0,
            # no-drop capacity (C >= T) so decode == prefill exactly in the
            # smoke equivalence test; full configs keep realistic 1.25
            capacity_factor=float(max(self.n_experts, 8)),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 2) if self.ssm_heads else 0,
            ssm_head_dim=min(self.ssm_head_dim, 16) if self.ssm_head_dim else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_frames=min(self.enc_frames, 16) if self.enc_frames else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            window=min(self.window, 32) if self.window else 0,
            remat=False,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train|prefill|decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
