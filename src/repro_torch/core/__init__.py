"""AESPA core on PyTorch: the cost model, hardware database, workloads and
the single- and many-kernel schedulers (numpy, copied from ``repro.core``)
and the executors that run their schedules on the card."""
