"""qwen3-0.6b [dense]: 28L, d_model 1024, 16 heads GQA kv=8, head_dim 128,
d_ff 3072, vocab 151936, qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", arch_type="dense", source="hf:Qwen/Qwen3-8B",
        num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=3072, vocab_size=151936, max_seq_len=32768,
        qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
        dtype="bfloat16", param_dtype="bfloat16",
    )
