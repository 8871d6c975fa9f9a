"""mixtral-8x22b [moe]: 56L, d_model 6144, 48 heads GQA kv=8, d_ff 16384,
8 experts top-2 on every layer, sliding-window attention (W=4096),
vocab 32768 [arXiv:2401.04088]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", arch_type="moe", source="arXiv:2401.04088",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768, max_seq_len=65536,
        num_experts=8, num_experts_per_tok=2, moe_every=1,
        moe_impl="dispatch", sliding_window=4096,
        rope_theta=1_000_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )
