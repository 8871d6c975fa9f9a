"""jamba-v0.1-52b [hybrid]: 32L, d_model 4096, Mamba:attention 7:1
(one attention layer per 8, at offset 4), GQA kv=8, d_ff 14336, MoE 16
experts top-2 on every second layer, vocab 65536 [arXiv:2403.19887]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", arch_type="hybrid", source="arXiv:2403.19887",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536, max_seq_len=262144,
        block_kind="mamba", attn_period=8, attn_offset=4,
        num_experts=16, num_experts_per_tok=2, moe_every=2,
        moe_impl="dispatch",
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        rope_theta=10_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )
