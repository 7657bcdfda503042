"""Architecture registry of the port.  Importing this package registers
every config the port supports; ``ASSIGNED_ARCHS`` is the reference's
list of assigned architectures, of which the port refuses the ids in
``base.NOT_PORTED`` (``get_config`` raises NotImplementedError naming
their ROADMAP item)."""
from repro_torch.configs.base import (NOT_PORTED, ModelConfig, SpecPVConfig,
                                      DraftConfig, get_config, register)
from repro_torch.configs import dbrx_132b  # noqa: F401
from repro_torch.configs import deepseek_7b  # noqa: F401
from repro_torch.configs import granite_3_2b  # noqa: F401
from repro_torch.configs import granite_moe_1b  # noqa: F401
from repro_torch.configs import paper_models  # noqa: F401
from repro_torch.configs import qwen1_5_32b  # noqa: F401
from repro_torch.configs import qwen2_0_5b  # noqa: F401
from repro_torch.configs import rwkv6_3b  # noqa: F401

# assigned architectures (public-literature pool), the reference's order
ASSIGNED_ARCHS = (
    "granite-3-2b",
    "granite-moe-1b-a400m",
    "qwen2-0.5b",
    "rwkv6-3b",
    "llama-3.2-vision-90b",
    "whisper-small",
    "qwen1.5-32b",
    "recurrentgemma-2b",
    "deepseek-7b",
    "dbrx-132b",
)

__all__ = ["ModelConfig", "SpecPVConfig", "DraftConfig", "get_config",
           "register", "ASSIGNED_ARCHS", "NOT_PORTED"]
