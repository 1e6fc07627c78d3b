"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 (hf:meta-llama/Llama-3.2-3B family).

24 heads do not divide the 16-wide model axis: attention params stay
FSDP-sharded while FFN/vocab take TP (sharding/specs.py divisibility rule).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    act="silu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=160, vocab_size=512, dtype="float32",
    )
