"""qwen1.5-110b [dense]: 80L, d_model 8192, 64 heads GQA kv=8, d_ff 49152,
vocab 152064, QKV bias [hf:Qwen/Qwen1.5-0.5B family]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", arch_type="dense", source="hf:Qwen/Qwen1.5-0.5B",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=49152, vocab_size=152064, max_seq_len=32768,
        qkv_bias=True, rope_theta=1_000_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )
