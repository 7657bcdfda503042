"""qwen1.5-32b [dense]: multi-head attention, QKV bias.

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064  [hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        arch_type="dense",
        source="hf:Qwen/Qwen1.5-0.5B (family card, 32B dims)",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        act="silu",
        rope_theta=1_000_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
