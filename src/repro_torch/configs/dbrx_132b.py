"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4 fine-grained (hf:databricks/dbrx-base).

Full AESPA technique site: MoE dispatch/combine is the paper's U_T C_E
SpMM dataflow (DESIGN.md §4); experts shard 1:1 over the 16-wide model
axis (EP)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    rope_theta=500_000.0,
    act="silu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=96, vocab_size=512, n_experts=4, experts_per_token=2,
        dtype="float32",
    )
