from repro_torch.kernels.moe_gemm.ops import moe_expert_ffn  # noqa: F401
from repro_torch.kernels.moe_gemm.ref import moe_expert_ffn_ref  # noqa: F401
