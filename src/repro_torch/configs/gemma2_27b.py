"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local+global alternating attention, logit softcaps. [arXiv:2408.00118; hf]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        d_ff=36864,
        vocab_size=256_000,
        head_dim=128,
        attn_pattern="LG",          # alternating local/global
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        tie_embeddings=True,
        source="arXiv:2408.00118; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=16, remat="none",
    )


register("gemma2-27b", full, smoke)
