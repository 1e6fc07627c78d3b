"""deepseek-v2-lite [moe] — 27L d_model=2048 16H, latent attention (MLA:
kv_lora_rank 512, no q-LoRA, q·k heads of 128 + 64 rope, values of 128),
layer 0 a dense SwiGLU of 10944, then 64 routed experts of 1408 top-6
(softmax over all 64, shares unrenormalised) plus 2 shared experts,
vocab=102400 untied, YaRN x40 over 4096 positions
(hf:deepseek-ai/DeepSeek-V2-Lite, arXiv:2405.04434).

The port's own architecture: the JAX package has none of its blocks.
Departures from the published model, each the port's:

* RoPE rotates half-split pairs; DeepSeek-V2 rotates interleaved pairs.
  The two are the same map under a fixed permutation of the 64 rope
  columns of ``W_q`` and ``W_kva``.
* The embedding is scaled by sqrt(d_model) on lookup, as in every model
  of the port; DeepSeek-V2 does not scale it.
* The token table and head are padded to a multiple of 256 rows (102400
  already is).
* Capacity-bounded expert dispatch (``capacity_factor``): DeepSeek-V2's
  inference is dropless; a factor of at least E/k = 10.67 makes prefill
  drop no token.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=192,                  # q·k width: 128 nope + 64 rope
    d_ff=1408,                   # each routed and shared expert
    vocab_size=102400,
    n_experts=64,
    experts_per_token=6,
    capacity_factor=11.0,        # >= E/k = 10.67: prefill drops no token
    n_shared_experts=2,
    router_scoring="softmax",
    first_dense_layers=1,
    d_ff_dense=10944,
    layer_pattern=("mla",),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    yarn_factor=40.0,
    yarn_original_len=4096,
    act="silu",
    norm_eps=1e-6,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    """Every kind present at CPU size: the dense layer 0, MLA, shared
    experts, the softmax router and YaRN, whose original length (16) lies
    below a test's positions."""
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=24,
        d_ff=32, vocab_size=512, n_experts=8, experts_per_token=3,
        d_ff_dense=96, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, yarn_factor=4.0,
        yarn_original_len=16, dtype="float32",
    )
