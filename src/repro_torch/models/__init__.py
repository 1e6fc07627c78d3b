"""The LM zoo of the port (``repro.models``): configs, the blocks of every
family (attention, MoE, SSD, RG-LRU, the enc-dec encoder and cross
attention), flash attention's forward and the :class:`Model` facade."""
from repro_torch.models.config import (
    AespaConfig,
    ModelConfig,
    SHAPES,
    SHAPES_BY_NAME,
    ShapeSpec,
)
from repro_torch.models.zoo import Model, build, params_from_numpy

__all__ = ["AespaConfig", "ModelConfig", "SHAPES", "SHAPES_BY_NAME",
           "ShapeSpec", "Model", "build", "params_from_numpy"]
