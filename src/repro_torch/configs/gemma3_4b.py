"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
5:1 local:global attention pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        d_ff=10240,
        vocab_size=262_144,
        head_dim=256,
        attn_pattern="LLLLLG",      # 5 local : 1 global
        sliding_window=1024,
        rope_theta=1_000_000.0,
        qk_norm=True,
        tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt (scaled); unverified",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=16, remat="none",
    )


register("gemma3-4b", full, smoke)
