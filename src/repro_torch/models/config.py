"""Model configuration system covering every assigned architecture family
— the port of ``repro.models.config``, field for field.

One frozen dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM
LMs; per-arch modules in ``repro_torch/configs`` instantiate it with the
exact published hyper-parameters plus a ``reduced()`` variant for CPU smoke
tests. Two differences: :attr:`ModelConfig.param_dtype` is a torch
dtype, and the port's own fields (latent attention, YaRN, shared experts,
the router's scoring, leading dense layers; :data:`PORT_FIELDS`) describe
DeepSeek-V2's blocks, which the JAX package does not run. Their defaults
leave every one of the JAX package's configurations as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


#: ``ModelConfig.dtype`` names -> torch dtypes.
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class AespaConfig:
    """Paper-technique integration knobs (core.hetero_matmul / MoE SpMM)."""

    enabled: bool = True
    # Treat MoE dispatch as the paper's (U_T C_E) SpMM dataflow.
    moe_spmm: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None     # window for 'local' layers
    # Layer-kind pattern (repeating period + tail), e.g. gemma3 5:1
    # local:global = ("local",)*5 + ("global",). None => all 'global'.
    layer_pattern: Optional[Tuple[str, ...]] = None

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # Shared experts: one SwiGLU of width n_shared_experts * d_ff on every
    # token, added to the routed sum.
    n_shared_experts: int = 0
    # "topk_softmax": a softmax over the top k logits (they sum to 1);
    # "softmax": a softmax over all E, the top k kept unrenormalised.
    router_scoring: str = "topk_softmax"
    # Leading layers whose FFN is a dense SwiGLU of width d_ff_dense.
    first_dense_layers: int = 0
    d_ff_dense: int = 0

    # --- latent attention (MLA, DeepSeek-V2; layer kind "mla") -------------
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN (DeepSeek-V2's rope_scaling, its other keys as published:
    # models/mla.py); yarn_factor 0 => plain RoPE.
    yarn_factor: float = 0.0
    yarn_original_len: int = 0

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (RG-LRU) ------------------------------------------------------
    rglru_width: Optional[int] = None        # recurrence width (d_model-ish)
    rglru_conv_width: int = 4

    # --- enc-dec (whisper) -----------------------------------------------------
    n_enc_layers: int = 0                     # 0 => decoder-only
    enc_seq_fraction: float = 0.5             # share of seq_len for encoder

    # --- modality frontend stubs ------------------------------------------------
    frontend: Optional[str] = None            # 'audio_stub' | 'vision_stub'
    n_frontend_tokens: int = 0                # patches / frames prepended

    # --- numerics / execution ------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    remat: str = "block"                      # none | block
    attn_chunk: int = 1024                    # flash-chunk size (prefill)
    # flash_vjp: custom-VJP flash (recompute-in-backward, EXPERIMENTS §Perf)
    # flash_naive: scan-differentiated baseline (stacks O(S²) residuals)
    attn_impl: str = "flash_vjp"
    act: str = "silu"                         # silu (swiglu) | gelu
    aespa: AespaConfig = AespaConfig()

    def __post_init__(self):
        # A pattern given as a list (a JSON file's) is kept as a tuple.
        if self.layer_pattern is not None:
            object.__setattr__(self, "layer_pattern",
                               tuple(self.layer_pattern))

    # -------------------------------------------------------------- helpers
    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def d_inner(self) -> int:                 # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (DESIGN.md §5 long_500k policy)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # Sliding-window-dominant dense models (gemma3 5:1 local:global).
        return self.layer_pattern is not None and self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch has an autoregressive decoder

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list of length n_layers."""
        return self._kinds(self.n_layers)

    def _kinds(self, n: int) -> Tuple[str, ...]:
        if self.layer_pattern is None:
            return ("global",) * n
        period = self.layer_pattern
        reps = -(-n // len(period))
        return (period * reps)[:n]

    def lead_kinds(self) -> Tuple[str, ...]:
        """The kinds of the ``first_dense_layers`` leading layers, which
        stand before the scanned periods."""
        return self.layer_kinds()[:self.first_dense_layers]

    def pattern_split(self) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
        """(n_periods, period, tail) for super-block scanning, over the
        layers after the leading dense ones (the pattern starts again
        there)."""
        n = self.n_layers - self.first_dense_layers
        if self.layer_pattern is None:
            return n, ("global",), ()
        period = self.layer_pattern
        n_periods = n // len(period)
        tail = self._kinds(n)[n_periods * len(period):]
        return n_periods, period, tail

    @property
    def mla(self) -> bool:
        """Latent attention in some layer."""
        return "mla" in self.layer_kinds()

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA grouping"
        if self.family == "moe":
            assert self.n_experts > 0 and self.experts_per_token > 0
        if self.family == "ssm":
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.family == "encdec":
            assert self.n_enc_layers > 0
        if self.frontend is not None:
            assert self.n_frontend_tokens > 0
        if self.mla:
            assert min(self.kv_lora_rank, self.qk_nope_head_dim,
                       self.qk_rope_head_dim, self.v_head_dim) > 0
        if self.first_dense_layers:
            assert 0 < self.first_dense_layers < self.n_layers
            assert self.d_ff_dense > 0
        assert self.router_scoring in ("topk_softmax", "softmax")

    def param_count(self) -> int:
        """Approximate trainable parameter count (docs/roofline 6ND)."""
        d, h, kv, dh, f, v = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.d_head, self.d_ff, self.vocab_size)
        embed = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            per = (d * (2 * di + 2 * ns + self.ssm_heads)   # in_proj (x,z,B,C,dt)
                   + di * d                                  # out_proj
                   + di + self.ssm_heads * 2)                # conv/dt/A/D-ish
            return embed + self.n_layers * per
        attn = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        if self.mla:
            r, qk = self.kv_lora_rank, self.qk_nope_head_dim
            rope, dv = self.qk_rope_head_dim, self.v_head_dim
            attn = (d * h * (qk + rope) + d * (r + rope) + r
                    + r * h * (qk + dv) + h * dv * d)
        if self.act == "silu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per = attn + mlp
        if self.family == "moe":
            per = attn + (self.n_experts + self.n_shared_experts) * (3 * d * f)
        if self.family == "hybrid":
            kinds = self.layer_kinds()
            rw = self.rglru_width or d
            rec = (2 * d * rw + rw * d + 3 * rw + rw * self.rglru_conv_width
                   + 2 * d * f + f * d)
            att = attn + 2 * d * f + f * d
            return embed + sum(rec if k == "recurrent" else att for k in kinds)
        total = embed + self.n_layers * per
        if self.first_dense_layers:
            total += self.first_dense_layers * (3 * d * self.d_ff_dense
                                                + attn - per)
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn.
            total += self.n_enc_layers * (attn + mlp)
            total += self.n_layers * attn      # cross-attention blocks
        return total


#: The fields the JAX package's ``ModelConfig`` does not have; their
#: defaults describe no block of its configurations.
PORT_FIELDS = (
    "n_shared_experts", "router_scoring", "first_dense_layers",
    "d_ff_dense", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
    "v_head_dim", "yarn_factor", "yarn_original_len")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
