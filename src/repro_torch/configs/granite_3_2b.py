"""granite-3-2b [dense]: GQA.

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155, tied embeddings
[hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-3-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        arch_type="dense",
        source="hf:ibm-granite/granite-3.0-2b-base",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=49155,
        act="silu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
