"""The paper's evaluation models (Sec. 4.1) and the local test model.

LLaMA-3.1-8B-Instruct [arXiv:2407.21783] and Qwen3-8B [arXiv:2505.09388].
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama3.1-8b")
def llama31_8b() -> ModelConfig:
    return ModelConfig(
        name="llama3.1-8b",
        arch_type="dense",
        source="arXiv:2407.21783",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        act="silu",
        rope_theta=500_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )


@register("qwen3-8b")
def qwen3_8b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        arch_type="dense",
        source="arXiv:2505.09388",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        act="silu",
        rope_theta=1_000_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )


@register("tiny-dense")
def tiny_dense() -> ModelConfig:
    """~10M-param dense model used by the CPU tests."""
    return ModelConfig(
        name="tiny-dense",
        arch_type="dense",
        source="(local test model)",
        num_layers=4,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=1024,
        vocab_size=512,
        act="silu",
        rope_theta=10_000.0,
    )


@register("target-100m")
def target_100m() -> ModelConfig:
    """~100M-param dense model for the end-to-end training example."""
    return ModelConfig(
        name="target-100m",
        arch_type="dense",
        source="(local 100M trainer)",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        d_ff=3072,
        vocab_size=8192,
        act="silu",
        rope_theta=10_000.0,
    )
