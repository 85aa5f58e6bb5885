"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.
Encoder-decoder; conv frontend is a STUB (input_specs() provides precomputed
frame embeddings, 1500 frames).  Decode shapes apply to the text decoder
mechanically (see DESIGN.md §Arch-applicability). [arXiv:2212.04356]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        num_layers=4,                # decoder layers
        num_encoder_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51_865,
        head_dim=64,
        encoder_seq=1500,
        source="arXiv:2212.04356; unverified",
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        encoder_seq=16, remat="none",
    )


register("whisper-tiny", full, smoke)
