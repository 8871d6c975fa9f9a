"""pixtral-12b [vlm]: language backbone 40L, d_model 5120, 32 heads GQA kv=8,
head_dim 128, d_ff 14336, vocab 131072; vision patches come from the STUB
frontend as precomputed prefix embeddings [hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", arch_type="vlm", source="hf:mistralai/Pixtral-12B-2409",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131072, max_seq_len=131072,
        rope_theta=1_000_000_000.0,
        frontend="vision", num_prefix_embeddings=256,
        dtype="bfloat16", param_dtype="bfloat16",
    )
