"""dbrx-132b [moe]: 16 fine-grained experts, top-4.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert) vocab=100352
[hf:databricks/dbrx-base].  Its full width does not fit one card: the
port runs its ``reduced()`` form.
"""
from repro_torch.configs.base import ModelConfig, register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        arch_type="moe",
        source="hf:databricks/dbrx-base",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        num_experts=16,
        experts_per_token=4,
        act="silu",
        rope_theta=500_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
