"""whisper-small [audio]: encoder-decoder, conv frontend stubbed.

12L(enc)+12L(dec) d_model=768 12H (kv=12) d_ff=3072 vocab=51865
[arXiv:2212.04356]

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: ``models.api.extra_inputs_for`` gives pre-computed frame
embeddings [B, num_audio_frames, d_model]; the model owns the encoder
stack and the decoder (self-attention, cross-attention, MLP), which is
where SpecPV verifies.
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        arch_type="audio",
        source="arXiv:2212.04356",
        num_layers=12,            # decoder layers
        encoder_layers=12,
        num_audio_frames=1500,    # 30 s of audio after conv downsampling
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        qkv_bias=True,
        act="gelu",
        rope_theta=10_000.0,      # rope in place of learned abs-pos
        tie_embeddings=True,
        dtype="bfloat16",
        param_dtype="bfloat16",
    )
