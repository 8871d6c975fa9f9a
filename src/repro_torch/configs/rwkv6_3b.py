"""rwkv6-3b [ssm] "Finch": 32L, d_model 2560 (40 heads x 64), attention-free
data-dependent-decay linear recurrence, channel-mix d_ff 8960, vocab 65536
[arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", arch_type="ssm", source="arXiv:2404.05892",
        num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=8960, vocab_size=65536, max_seq_len=1048576,
        block_kind="rwkv", rwkv_head_dim=64, rwkv_lora_rank=64,
        dtype="bfloat16", param_dtype="bfloat16",
    )
