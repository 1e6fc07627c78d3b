"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024,
vocab=50304, 64 experts top-8 (arXiv:2409.02060).

Fine-grained MoE: 64 experts over the 16-wide model axis (4 per shard);
dispatch is the AESPA U_T C_E SpMM site (DESIGN.md §4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=64, vocab_size=512, n_experts=8, experts_per_token=2,
        dtype="float32",
    )
