"""deepseek-7b [dense]: llama architecture, multi-head attention.

30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400  [arXiv:2401.02954]
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        arch_type="dense",
        source="arXiv:2401.02954",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=102400,
        act="silu",
        rope_theta=10_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
