"""The optimizer of the port (``repro.optim``): AdamW with JAX's semantics
and gradient compression with error feedback."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    apply_updates,
    global_norm,
    init_state,
    lr_at,
)
from repro_torch.optim.compress import Compressor, compress_with_feedback, init_error

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "lr_at", "Compressor", "compress_with_feedback", "init_error"]
