"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention, 1 attention : 2 recurrent
(arXiv:2402.19427, Griffin).

Sub-quadratic hybrid: runs long_500k (bounded-window attention + O(1)
recurrent state). The RG-LRU recurrence is elementwise — AESPA applies to
the surrounding projections only (DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab_size=256000,
    sliding_window=2048,
    layer_pattern=("recurrent", "recurrent", "local"),
    rglru_width=2560,
    act="gelu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=1, d_head=32,
        d_ff=128, vocab_size=512, sliding_window=16, rglru_width=64,
        dtype="float32",
    )
