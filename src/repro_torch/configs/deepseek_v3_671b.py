"""deepseek-v3-671b — 61L d_model=7168 128H, MLA, MoE 256 routed (top-8)
+ 1 shared expert (d_ff=2048), first 3 layers dense (d_ff=18432), MTP
[arXiv:2412.19437].

The full model (1.34 TB in bf16) does not fit one card; the port serves it
at published width with the depth cut (``dataclasses.replace(CONFIG,
n_layers=4)``: the 3 dense layers and one MoE layer), which keeps every
shape: MLA ranks 1536/512, 128 heads of 128 + 64, Dv 128, 256 experts."""

import dataclasses

from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,
    vocab_size=129_280,
    mlp_kind="swiglu",
    n_experts=256,
    n_experts_per_tok=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    n_dense_layers=3,
    mla=MLAConfig(),
    mtp=True,
    optimizer="adafactor",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, n_experts=4,
        n_experts_per_tok=2, n_shared_experts=1, moe_d_ff=32,
        n_dense_layers=1, moe_capacity_factor=8.0,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
    )
