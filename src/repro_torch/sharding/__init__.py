"""Sharding specs of the port (``repro.sharding``'s counterpart): JAX's
partition rules, and their DTensor placements on a ``DeviceMesh``."""
from repro_torch.sharding.specs import (
    FSDP,
    MODEL,
    NamedSharding,
    P,
    cache_pspecs,
    distribute,
    leaf_spec,
    mesh_device,
    named_shardings,
    param_pspecs,
    shard_tensor,
    to_placements,
)

__all__ = ["FSDP", "MODEL", "NamedSharding", "P", "cache_pspecs",
           "distribute", "leaf_spec", "mesh_device", "named_shardings",
           "param_pspecs", "shard_tensor", "to_placements"]
