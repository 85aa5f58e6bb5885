"""Config system: one dataclass describes every architecture in the zoo.

The same fields and registry as ``repro.configs.base``, with torch dtypes.
Family selects the model implementation in ``repro_torch.models``:
  dense   - decoder-only transformer (GQA/sliding-window/softcap variants)
  moe     - dense attention (or MLA) + mixture-of-experts FFN
  ssm     - RWKV6 (attention-free)
  hybrid  - Hymba (parallel attention + SSM heads)
  encdec  - Whisper (encoder-decoder, stub audio frontend)
  vlm     - InternVL2 (stub vision frontend + decoder LM)
Every family is implemented (``repro_torch.models.registry``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

ATTN_IMPLS = ("ref", "kernel")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads

    # -- attention variants ------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: int = 4096       # window for "L" layers
    # layer pattern, repeated over depth: "G"=global attn, "L"=local/sliding.
    attn_pattern: str = "G"
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    tie_embeddings: bool = False

    # -- MLA (deepseek-v2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0             # routed experts (0 = dense FFN)
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    first_dense_layers: int = 0      # leading dense layers (deepseek)
    capacity_factor: float = 1.25
    moe_impl: str = "dispatch"       # dispatch (GShard einsum) | ragged (sort)
    aux_loss_coef: float = 0.01

    # -- SSM / RWKV / hybrid ---------------------------------------------------
    ssm_state: int = 16              # mamba d_state (hymba)
    ssm_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # hybrid: indices of full-attention layers (others sliding window)
    full_attn_layers: tuple[int, ...] = ()
    num_meta_tokens: int = 0

    # -- enc-dec / multimodal ---------------------------------------------------
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # frames (whisper) / patches (internvl)
    num_patches: int = 0

    # -- numerics / execution ---------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_scores_dtype: str = "float32"
    remat: str = "full"              # none | full | dots (training; unused by decode)
    # ref: plain torch; kernel: the hand-written CUDA kernels (flash
    # attention on the full-sequence path, decode attention on full-cache
    # layers, the moe expert FFN), which run their plain versions on CPU tensors
    attn_impl: str = "ref"
    scan_layers: bool = True
    norm_eps: float = 1e-6

    source: str = ""                 # provenance note

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.models import registry
        return registry.param_count(self)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
