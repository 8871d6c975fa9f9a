"""granite-34b [dense]: 88L, d_model 6144, 48 heads MQA (kv=1), d_ff 24576,
vocab 49152 — llama-architecture code model [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", arch_type="dense", source="arXiv:2405.04324",
        num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152, max_seq_len=8192,
        rope_theta=10_000.0, act="gelu", ffn_kind="mlp",
        dtype="bfloat16", param_dtype="bfloat16",
    )
