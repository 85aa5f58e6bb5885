"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.
Parallel attention + Mamba heads in every layer; ssm_state=16; 128 meta
tokens; full attention only in layers {0, 15, 31}, sliding window elsewhere.
[arXiv:2411.13676; hf]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32_001,
        head_dim=64,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        sliding_window=1024,
        full_attn_layers=(0, 15, 31),
        num_meta_tokens=128,
        source="arXiv:2411.13676; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, ssm_state=8, sliding_window=16,
        full_attn_layers=(0,), num_meta_tokens=8, remat="none",
    )


register("hymba-1.5b", full, smoke)
