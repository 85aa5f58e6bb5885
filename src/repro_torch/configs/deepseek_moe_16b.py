"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) vocab=102400.
Fine-grained MoE: 2 shared + 64 routed experts, top-6, expert d_ff=1408.
First layer dense (d_ff chosen to match active MoE compute: (6+2)*1408).
[arXiv:2401.06066; hf]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=11264,                 # dense first-layer FFN = (top_k+shared)*1408
        vocab_size=102_400,
        head_dim=128,
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        first_dense_layers=1,
        source="arXiv:2401.06066; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=256, vocab_size=512, num_experts=8, top_k=2, moe_d_ff=32,
        num_shared_experts=1, first_dense_layers=1, remat="none",
    )


register("deepseek-moe-16b", full, smoke)
