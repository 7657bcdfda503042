"""Small helpers of the port (counterpart of ``repro/utils/misc.py``)."""
from repro_torch.utils.misc import cdiv, human_bytes, round_up, tree_size_bytes

__all__ = ["cdiv", "round_up", "tree_size_bytes", "human_bytes"]
