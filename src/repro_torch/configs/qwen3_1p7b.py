"""qwen3-1.7b [dense]: the paper's own backbone family (Qwen3-1.7B-Base):
28L, d_model 2048, 16 heads GQA kv=8, head_dim 128, d_ff 6144,
vocab 151936, qk-norm [arXiv:2505.09388; paper §4.1]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", arch_type="dense", source="arXiv:2505.09388",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=6144, vocab_size=151936, max_seq_len=32768,
        qk_norm=True, rope_theta=1_000_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )
