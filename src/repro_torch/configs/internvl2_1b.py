"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT frontend + Qwen2-0.5B-style LM backbone
(arXiv:2404.16821).

The ViT is a STUB per the assignment: input_specs provides 256 precomputed
patch embeddings prepended to the text sequence via a learned adapter."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    n_frontend_tokens=256,
    act="silu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512, n_frontend_tokens=8, dtype="float32",
    )
