"""whisper-tiny [audio]: encoder-decoder, 4+4L, d_model 384, 6 heads,
d_ff 1536, vocab 51865; the mel+conv frontend is a STUB supplying 1500
frame embeddings; decoder uses learned positions [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", arch_type="audio", source="arXiv:2212.04356",
        num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
        d_ff=1536, vocab_size=51865, max_seq_len=448,
        encoder_layers=4, encoder_frames=1500, cross_attention=True,
        frontend="audio", pos_embed="learned", act="gelu", ffn_kind="mlp",
        dtype="bfloat16", param_dtype="bfloat16",
    )
