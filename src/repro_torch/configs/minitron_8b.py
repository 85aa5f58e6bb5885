"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Pruned Nemotron. [arXiv:2407.14679; hf]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=256_000,
        head_dim=128,
        attn_pattern="G",
        source="arXiv:2407.14679; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, remat="none",
    )


register("minitron-8b", full, smoke)
