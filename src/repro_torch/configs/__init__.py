from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
)

# Import arch modules for registration side effects.
from repro_torch.configs import (  # noqa: F401
    gemma3_4b,
    granite_34b,
    minitron_8b,
    gemma2_27b,
    deepseek_moe_16b,
    deepseek_v2_lite_16b,
    internvl2_76b,
    rwkv6_3b,
    hymba_1_5b,
    whisper_tiny,
)
