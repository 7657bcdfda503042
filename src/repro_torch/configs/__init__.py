"""Architecture registry of the port.  Importing this package registers
every config the port supports."""
from repro_torch.configs.base import (ModelConfig, SpecPVConfig, DraftConfig,
                                      get_config, register)
from repro_torch.configs import paper_models  # noqa: F401
from repro_torch.configs import rwkv6_3b  # noqa: F401

__all__ = ["ModelConfig", "SpecPVConfig", "DraftConfig", "get_config",
           "register"]
