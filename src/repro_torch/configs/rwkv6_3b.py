"""rwkv6-3b [ssm]: Finch, data-dependent decay, attention-free.

32L d_model=2560 d_ff=8960 vocab=65536  [arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        arch_type="ssm",
        source="arXiv:2404.05892",
        num_layers=32,
        d_model=2560,
        num_heads=40,          # wkv heads = d_model / ssm_head_dim
        num_kv_heads=40,
        ssm_head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        act="relu_sq",         # rwkv channel-mix uses squared relu
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
