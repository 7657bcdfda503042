"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, pattern
(rec, rec, attn).

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000  [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        arch_type="hybrid",
        source="arXiv:2402.19427 (Griffin) / RecurrentGemma-2B card",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        layer_pattern=("rec", "rec", "attn"),
        window_size=2048,
        rnn_width=2560,
        act="gelu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
