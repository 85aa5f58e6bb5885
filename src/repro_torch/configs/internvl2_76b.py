"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Llama-3-70B-class text backbone; InternViT frontend is a STUB: input_specs()
provides 256 pre-projected patch embeddings per image at d_model.
[arXiv:2404.16821; unverified]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128_256,
        head_dim=128,
        num_patches=256,
        rope_theta=500_000.0,
        source="arXiv:2404.16821; unverified",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, num_patches=8, remat="none",
    )


register("internvl2-76b", full, smoke)
