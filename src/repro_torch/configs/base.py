"""Architecture + run configuration for the framework.

A copy of ``repro.configs.base`` (dataclasses only, no JAX).  Every
architecture the port can build gets a module
``src/repro_torch/configs/<id>.py`` exporting ``CONFIG`` (exact published
dims) and ``smoke_config()`` (a reduced same-family config for CPU tests);
``repro_torch.configs.get(name)`` resolves both.

The sharding of every parameter/activation is expressed with *logical axis
names* resolved through ``ShardingRules`` — the MaxText-style indirection that
lets the §Perf loop re-map axes without touching model code.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims (arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    mlp_kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    qk_norm: bool = False
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0          # leading dense layers (deepseek: 3)
    moe_capacity_factor: float = 1.25
    # --- MLA / MTP (deepseek) ------------------------------------------------
    mla: MLAConfig | None = None
    mtp: bool = False                # multi-token-prediction auxiliary head
    # --- attention-free / hybrid ----------------------------------------------
    attn_free: bool = False          # rwkv6
    block_pattern: tuple[str, ...] = ("attn",)   # e.g. ("rec","rec","attn")
    local_window: int = 0            # sliding-window size for local attention
    lru_width: int = 0               # RG-LRU state width (0 -> d_model)
    # --- encoder-decoder --------------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    # --- modality frontend (stubbed per assignment) ------------------------------
    frontend: Literal[None, "vq_image", "audio_frames"] = None
    # --- numerics / optimization --------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer: Literal["adamw", "adafactor"] = "adamw"
    # remat: 'block' = full-block recompute (baseline), 'dots' = selective
    # (matmul outputs saved, elementwise recomputed), 'none'
    remat: Literal["none", "block", "dots"] = "block"
    # explicit sharding constraints on MoE dispatch buffers (§Perf B1)
    moe_dispatch_sharding: bool = False
    # MoE implementation: 'scatter' = pjit-auto (baseline; the partitioner
    # replicates the scatter operands), 'ep_shardmap' = explicit expert-
    # parallel shard_map (local dispatch + ZeRO weight gather + psum combine;
    # §Perf B2)
    moe_impl: Literal["scatter", "ep_shardmap"] = "scatter"
    # XLA flash-attention KV chunk: larger chunks -> fewer online-softmax
    # accumulator rewrites (§Perf C3)
    attn_kv_chunk: int = 1024
    # subquadratic archs support the 500k decode cell
    subquadratic: bool = False
    # cost-probe mode: fully unroll layer scans so XLA cost_analysis counts
    # every layer (a while-loop body is otherwise counted ONCE — see
    # EXPERIMENTS.md §Dry-run "scan-body undercount")
    scan_unroll: bool = False

    # ---- derived -------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        V, D, F, H = self.vocab_size, self.d_model, self.d_ff, self.n_heads
        hd, kvh = self.head_dim, self.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            attn = (
                D * m.q_lora_rank
                + m.q_lora_rank * H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * D
            )
        elif self.attn_free:
            attn = 6 * D * D + 2 * D  # rwkv6 token-mix approx (r,k,v,g,o + decay)
        else:
            attn = D * H * hd + 2 * D * kvh * hd + H * hd * D
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        dense_mlp = gates * D * F
        if self.n_experts:
            moe_mlp = gates * D * self.moe_d_ff * (
                self.n_experts + self.n_shared_experts
            ) + D * self.n_experts
            n_moe = self.n_layers - self.n_dense_layers
            blocks = self.n_layers * attn + self.n_dense_layers * dense_mlp \
                + n_moe * moe_mlp
        else:
            blocks = self.n_layers * (attn + dense_mlp)
        if self.is_encoder_decoder:
            # encoder blocks + decoder cross-attention
            blocks += self.encoder_layers * (attn + dense_mlp)
            blocks += self.n_layers * attn      # cross-attn per decoder layer
        return emb + blocks

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k), for 6·N_active·D."""
        if not self.n_experts:
            return self.param_count()
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        full_moe = gates * self.d_model * self.moe_d_ff * (
            self.n_experts + self.n_shared_experts
        )
        act_moe = gates * self.d_model * self.moe_d_ff * (
            self.n_experts_per_tok + self.n_shared_experts
        )
        n_moe = self.n_layers - self.n_dense_layers
        return self.param_count() - n_moe * (full_moe - act_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the evaluation matrix."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of axes, or None = replicated)."""
    batch: tuple[str, ...] = ("pod", "data")
    fsdp: str | None = "data"        # non-TP param axis sharding (ZeRO-3)
    tensor: str | None = "model"     # heads / mlp / vocab
    expert: str | None = "model"     # MoE expert axis (EP)
    sequence: str | None = None      # SP for long-context activations
    act_embed: str | None = None     # shard activations' d_model axis
    mesh: object = dataclasses.field(default=None, compare=False,
                                     repr=False)  # for shard_map paths

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        table = {
            "batch": self.batch,
            "fsdp": self.fsdp,
            "tensor": self.tensor,
            "expert": self.expert,
            "sequence": self.sequence,
            "act_embed": self.act_embed,
        }
        return table[logical]


DEFAULT_RULES = ShardingRules()
