"""The port's dataflow kernels: one module per class, each holding CUDA
C++ kernels for Hopper (``csrc/``) beside a plain PyTorch version of the
same function, plus ``ops`` (padding, device, dispatch) and ``ref``
(dense oracles). Importing builds nothing: a kernel is built at its first
launch.

Re-exported as ``repro.kernels`` does, except two kinds of name: the
``ops`` functions named like a kernel module (``gemm``, ``spmm``,
``spgemm_inner``, ``spgemm_outer``, ``spgemm_gustavson``) stay under
``repro_torch.kernels.ops``, so that ``repro_torch.kernels.spmm`` is the
module; and the TPU's ``expand_major``/``expand_minor`` and
``default_interpret`` have no counterpart.
"""
from repro_torch.kernels import ref
from repro_torch.kernels.ops import (
    DISPATCH,
    dispatch,
    resolve_device,
    spmm_mirror,
)

__all__ = ["ref", "DISPATCH", "dispatch", "resolve_device", "spmm_mirror"]
