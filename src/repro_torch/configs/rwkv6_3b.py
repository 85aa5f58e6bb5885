"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
RWKV-6 "Finch": data-dependent decay, head_dim=64 (40 heads).
[arXiv:2404.05892; hf]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=40,               # d_model / rwkv_head_dim
        num_kv_heads=40,
        d_ff=8960,
        vocab_size=65_536,
        head_dim=64,
        rwkv_head_dim=64,
        source="arXiv:2404.05892; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        rwkv_head_dim=16, d_ff=128, vocab_size=512, remat="none",
    )


register("rwkv6-3b", full, smoke)
