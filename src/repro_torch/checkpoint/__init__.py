"""The checkpoint store of the port (``repro.checkpoint``)."""
from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
