"""whisper-base [audio] — enc-dec, conv frontend stubbed (arXiv:2212.04356).

6L (decoder) + 6L encoder, d_model=512, 8H (kv=8), d_ff=2048, vocab=51865.
The audio conv frontend is a STUB per the assignment: input_specs provides
precomputed frame embeddings consumed through a learned adapter.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab_size=51865,
    n_enc_layers=6,
    enc_seq_fraction=0.5,
    act="gelu",
    tie_embeddings=True,
    frontend=None,          # frames arrive via the encoder stub input
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab_size=512, dtype="float32",
    )
