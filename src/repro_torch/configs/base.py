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
    arch_type: str                      # "dense", "moe", "ssm", "hybrid",
                                        # "vlm" or "audio"
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
    cross_attn_every: int = 0           # a cross-attn layer every N layers
    num_image_tokens: int = 0
    vision_dim: int = 0                 # pre-projector vision feature dim

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

    @property
    def has_encoder(self) -> bool:
        return self.encoder_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-(decoder-)layer kind sequence: a hybrid repeats its
        pattern, cut to ``num_layers``; an audio decoder layer is "dec"
        (self-attention, cross-attention, MLP); a VLM makes every
        ``cross_attn_every``-th layer (1-indexed) a gated "cross"
        layer."""
        if self.arch_type == "ssm":
            return ("rwkv",) * self.num_layers
        if self.arch_type == "hybrid":
            pat = self.layer_pattern or ("rec", "rec", "attn")
            out = []
            while len(out) < self.num_layers:
                out.extend(pat)
            return tuple(out[: self.num_layers])
        if self.arch_type == "audio":
            return ("dec",) * self.num_layers
        if self.arch_type == "vlm" and self.cross_attn_every > 0:
            return tuple("cross" if (i + 1) % self.cross_attn_every == 0
                         else "attn" for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (the reference's formula, for a
        roofline's model FLOPs): attention and MLP per layer by kind,
        norms, the experts and their router, the embedding and head, and
        an encoder's layers."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        mlp = (3 if self.act == "silu" else 2) * d * dff
        total = 0
        kinds = self.layer_kinds()
        for kind in kinds:
            if kind in ("attn", "cross"):
                total += attn + mlp
            elif kind == "rwkv":
                total += 3 * d * d + mlp
            elif kind == "rec":
                w = self.rnn_width or d
                total += 3 * d * w + mlp
            if kind in ("attn", "cross", "rwkv", "rec"):
                total += 2 * d
        if self.num_experts:
            # the dense MLP counted above is one expert of each layer
            total += (self.num_experts - 1) * mlp * len(kinds)
            total += self.num_experts * d * len(kinds)
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.has_encoder:
            total += self.encoder_layers * (attn + mlp)
        return total

    def active_param_count(self) -> int:
        """Parameters one token touches (an MoE reads its top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        per = (3 if self.act == "silu" else 2) * self.d_model * self.d_ff
        return self.param_count() - ((self.num_experts
                                      - self.experts_per_token)
                                     * per * self.num_layers)

    def reduced(self) -> "ModelConfig":
        """CPU test variant of the same family (<= 2 layers, d_model <=
        256, <= 4 experts of which top-2), field for field the
        reference's ``reduced()``."""
        heads = max(2, min(self.num_heads, 4))
        kw = dict(name=self.name + "-reduced",
                  num_layers=min(self.num_layers, 2),
                  d_model=min(self.d_model, 256),
                  d_ff=min(self.d_ff, 512),
                  vocab_size=min(self.vocab_size, 512),
                  max_position=65536,
                  num_heads=heads,
                  num_kv_heads=max(1, min(self.num_kv_heads, heads)),
                  head_dim=0)
        if self.num_experts:
            kw.update(num_experts=min(self.num_experts, 4),
                      experts_per_token=min(self.experts_per_token, 2))
        if self.arch_type == "hybrid":
            # the family's two kinds in 2 layers: one rec, one attn
            kw.update(layer_pattern=("rec", "attn"),
                      window_size=min(self.window_size or 128, 128),
                      rnn_width=0)
        if self.arch_type == "vlm":
            kw.update(cross_attn_every=2, num_image_tokens=16,
                      vision_dim=min(self.vision_dim or 64, 64))
        if self.has_encoder:
            kw.update(encoder_layers=2, num_audio_frames=32)
        return self.replace(**kw)


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

# assigned architectures the port does not run yet -> their ROADMAP.md
# queue 1 item (none: every assigned id runs)
NOT_PORTED: Dict[str, str] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP.md queue 1, "
            f"'{NOT_PORTED[arch_id]}'")
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    """Every registered config id, sorted (the reference's ``list_archs``)."""
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
