"""llama-3.2-vision-90b [vlm]: interleaved gated cross-attention image
layers.

100L (80 self + 20 cross, a cross layer every 5th) d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256  [hf:meta-llama/Llama-3.2-11B-Vision]

The ViT/SigLIP vision encoder and its adapter are a stub, as in the
reference: ``models.api.extra_inputs_for`` gives pre-computed patch
embeddings [B, num_image_tokens, vision_dim]; the model owns the
projector into d_model and the gated cross-attention layers.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-90b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        arch_type="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision (90B scale-up)",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        cross_attn_every=5,
        num_image_tokens=1600,   # 1601-ish patches for 560px tiles
        vision_dim=1280,
        act="silu",
        rope_theta=500_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
