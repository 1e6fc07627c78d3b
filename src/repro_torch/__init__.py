"""AESPA on PyTorch and CUDA: a port of ``repro`` (JAX/Pallas on a TPU)
whose kernels are hand-written CUDA C++ for Hopper (``sm_90a``).

The layout mirrors ``repro``: ``formats/`` (ELL fibers on tensors),
``kernels/`` (one module per dataflow class, each with its CUDA kernel and
a plain PyTorch twin, plus ``ops`` dispatch) and ``core/`` (cost model,
scheduler and the executor). Entry points run on the card unless the
caller passes ``device="cpu"``; nothing here imports JAX or ``repro``.
"""
