"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality) — arXiv:2405.21060.

Sub-quadratic: runs long_500k with O(1) recurrent decode state. The paper's
sparse-attention sharding aspects are N/A for an attention-free arch
(DESIGN.md §5); intra-chunk SSD matmuls are GEMM-class sites."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,             # attention-free; SSD heads derive from d_inner
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    layer_pattern=("ssd",),
    act="silu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, vocab_size=512, dtype="float32",
    )
