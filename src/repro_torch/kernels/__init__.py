"""The port's dataflow kernels: one module per class, each holding CUDA
C++ kernels for Hopper (``csrc/``) beside a plain PyTorch version of the
same function, plus ``ops`` (padding, device, dispatch) and ``ref``
(dense oracles)."""
