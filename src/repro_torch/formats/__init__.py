"""Compression formats of the port: the CCF taxonomy and ELL fibers on
tensors."""
