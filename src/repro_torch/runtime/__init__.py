"""The fault-tolerant training driver of the port (``repro.runtime``)."""
from repro_torch.runtime.driver import DriverConfig, DriverReport, TrainDriver

__all__ = ["DriverConfig", "DriverReport", "TrainDriver"]
