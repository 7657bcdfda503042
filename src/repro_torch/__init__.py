"""PyTorch + CUDA port of the SpecPV reproduction, for one NVIDIA H100.

Mirrors the JAX package's subpackages (``configs``, ``models``,
``kvcache``, ``core``, ``kernels``, ``serving``).  Imports only ``torch``, numpy and
the standard library.  Every entry point runs on the CUDA device unless
the caller passes ``device="cpu"``; with no card it raises instead of
falling back.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
