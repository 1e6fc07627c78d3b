"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; 5:1 local:global sliding-window pattern, 128k-context lineage
(hf:google/gemma-3-1b-pt).

Sub-quadratic-dominant (sliding-window local layers) => runs long_500k
(DESIGN.md §5); global layers use the context-parallel sharded cache.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    sliding_window=512,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    act="gelu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=7, d_model=64, n_heads=2, n_kv_heads=1, d_head=32,
        d_ff=128, vocab_size=512, sliding_window=16, dtype="float32",
    )
