"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
Llama-style code model. [arXiv:2405.04324; hf]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24576,
        vocab_size=49_152,
        head_dim=128,
        attn_pattern="G",
        source="arXiv:2405.04324; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, remat="none",
    )


register("granite-34b", full, smoke)
