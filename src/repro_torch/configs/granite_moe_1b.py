"""granite-moe-1b-a400m [moe]: 32 experts, top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
tied embeddings  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-moe-1b-a400m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        arch_type="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        num_experts=32,
        experts_per_token=8,
        act="silu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
