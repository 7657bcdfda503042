"""Architecture registry of the port.  Importing this package registers
every config the port supports; ``ASSIGNED_ARCHS`` is the reference's
list of assigned architectures, every one of which the port runs
(``base.NOT_PORTED`` is empty; an id put there makes ``get_config``
raise NotImplementedError naming its ROADMAP item)."""
from repro_torch.configs.base import (NOT_PORTED, ModelConfig, SpecPVConfig,
                                      DraftConfig, get_config, list_archs,
                                      register)
from repro_torch.configs import dbrx_132b  # noqa: F401
from repro_torch.configs import deepseek_7b  # noqa: F401
from repro_torch.configs import granite_3_2b  # noqa: F401
from repro_torch.configs import granite_moe_1b  # noqa: F401
from repro_torch.configs import llama_3_2_vision_90b  # noqa: F401
from repro_torch.configs import paper_models  # noqa: F401
from repro_torch.configs import qwen1_5_32b  # noqa: F401
from repro_torch.configs import qwen2_0_5b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs import rwkv6_3b  # noqa: F401
from repro_torch.configs import whisper_small  # noqa: F401

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

# the reference's input shapes (its dry-run and hillclimb cases read them)
INPUT_SHAPES = {
    "train_4k":    dict(seq_len=4096,    global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,   global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,   global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288,  global_batch=1,   kind="decode"),
}

__all__ = ["ModelConfig", "SpecPVConfig", "DraftConfig", "get_config",
           "list_archs", "register", "ASSIGNED_ARCHS", "INPUT_SHAPES",
           "NOT_PORTED"]
