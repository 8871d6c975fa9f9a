"""deepseek-v3-671b [moe]: 61L, d_model 7168, 128 heads (MLA), MoE 256
routed experts top-8 + 1 shared (expert d_ff 2048, dense d_ff 18432 on the
first 3 layers), vocab 129280, MTP head [arXiv:2412.19437]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", arch_type="moe", source="arXiv:2412.19437",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=18432, vocab_size=129280, max_seq_len=8192,
        attention_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        num_experts=256, num_experts_per_tok=8, num_shared_experts=1,
        moe_d_ff=2048, first_dense_layers=3, moe_every=1,
        moe_impl="dispatch", mtp=True,
        rope_theta=10_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )
