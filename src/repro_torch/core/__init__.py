"""AESPA core on PyTorch: the cost model, hardware database, workloads and
single-kernel scheduler (numpy, copied from ``repro.core``) and the
executor that runs a schedule on the card."""
