"""Architecture registry of the port: the dense GQA configs (qwen3,
deepseek-7b, qwen1.5-110b, granite-34b), the mixture-of-experts
mixtral-8x22b, the RWKV6 trunk (rwkv6-3b), the Mamba + attention + MoE
hybrid jamba-v0.1-52b, the vision-prefix pixtral-12b, the encoder-decoder
whisper-tiny and deepseek-v3-671b (MLA, MoE with a shared expert, an MTP
head): every architecture of ``repro.configs``.
"""
from __future__ import annotations

import importlib
from repro_torch.models.config import ModelConfig

# arch id -> module name
ARCH_IDS = {
    "qwen3-0.6b": "qwen3_0p6b",
    "qwen3-1.7b": "qwen3_1p7b",
    "rwkv6-3b": "rwkv6_3b",
    "deepseek-7b": "deepseek_7b",
    "qwen1.5-110b": "qwen1p5_110b",
    "granite-34b": "granite_34b",
    "mixtral-8x22b": "mixtral_8x22b",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "pixtral-12b": "pixtral_12b",
    "whisper-tiny": "whisper_tiny",
    "deepseek-v3-671b": "deepseek_v3_671b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}' in the port; known: "
                       f"{sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch_id]}")
    cfg = mod.config()
    cfg.validate()
    return cfg

