"""qwen2-0.5b [dense]: GQA with 7 query heads per KV head, QKV bias.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, tied embeddings
[arXiv:2407.10671]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-0.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        arch_type="dense",
        source="arXiv:2407.10671",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        act="silu",
        rope_theta=1_000_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
