"""Config system of the PyTorch port: its own copy of the reference's
``ModelConfig``, ``SpecPVConfig`` and ``DraftConfig`` dataclasses and the
architecture registry (field for field the same; the port imports
nothing of the JAX package)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    arch_type: str                      # the port runs "dense" and "ssm"
    source: str = ""                    # citation for the config numbers

    # transformer trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                   # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"                   # "silu" (swiglu) | "gelu" (geglu/mlp)
    norm_eps: float = 1e-5

    # rope / long context
    rope_theta: float = 10_000.0
    yarn_factor: float = 1.0            # >1 enables YARN NTK-by-parts scaling
    yarn_orig_len: int = 4096           # original trained context for YARN
    max_position: int = 1 << 20

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_aux_loss_coef: float = 0.01

    # SSM (rwkv6)
    ssm_head_dim: int = 64

    # hybrid (recurrentgemma / griffin)
    layer_pattern: Tuple[str, ...] = ()
    window_size: int = 0                # local attention window
    rnn_width: int = 0                  # RG-LRU width (0 -> d_model)

    # vlm
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    vision_dim: int = 0

    # audio enc-dec (whisper)
    encoder_layers: int = 0
    num_audio_frames: int = 0

    # numerics
    dtype: str = "float32"              # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_arch(self) -> bool:
        return self.arch_type in ("dense", "moe", "vlm", "audio")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind sequence (the port runs dense and RWKV-6
        stacks)."""
        if self.arch_type == "ssm":
            return ("rwkv",) * self.num_layers
        return ("attn",) * self.num_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """CPU test variant of the same family (<= 2 layers, d_model <=
        256), field for field the reference's ``reduced()`` for the
        architectures the port runs."""
        heads = max(2, min(self.num_heads, 4))
        return self.replace(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            max_position=65536,
            num_heads=heads,
            num_kv_heads=max(1, min(self.num_kv_heads, heads)),
            head_dim=0)


@dataclass(frozen=True)
class SpecPVConfig:
    """Configuration of the paper's technique (Sec. 3.2/3.3)."""
    block_size: int = 128           # KV block (page) size
    num_sink_blocks: int = 1        # always-kept leading blocks
    retrieval_budget_blocks: int = 32   # Quest-retrieved blocks ("4K"=32)
    local_window_blocks: int = 2    # trailing full-resolution window
    buffer_size: int = 96           # partially-verified + candidate tokens
    reduction: str = "mean"         # mean | max | last   (Tab. 4)
    score_mode: str = "paper"       # "paper" eq.(2) | "quest" elementwise
    refresh_margin: int = 20        # paper: one verify step + margin of 20
    use_pallas: bool = False        # route attention/scoring through the
                                    # port's kernels (CUDA on the card,
                                    # their plain versions on the CPU)

    @property
    def partial_budget_tokens(self) -> int:
        return (self.num_sink_blocks + self.retrieval_budget_blocks
                + self.local_window_blocks) * self.block_size

    def replace(self, **kw) -> "SpecPVConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DraftConfig:
    """EAGLE-3-style draft module: one decoder layer over fused features."""
    num_layers: int = 1
    fuse_layers: Tuple[float, float, float] = (0.25, 0.5, 1.0)
    tree_depth: int = 5
    tree_branch: Tuple[int, ...] = (4, 2, 2, 1, 1)
    ttt_steps: int = 4
    ttt_alpha: float = 0.8
    draft_vocab: int = 0

    @property
    def tree_size(self) -> int:
        """Total candidate nodes (excl. root context token)."""
        n, level = 0, 1
        for b in self.tree_branch[: self.tree_depth]:
            level *= b
            n += level
        return n


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()
