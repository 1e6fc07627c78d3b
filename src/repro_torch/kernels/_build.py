"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` into a shared library of its own
with a plain C interface, for ``sm_90a``; the compilers run in parallel,
one per source. Libraries go to ``build/repro_torch/<hash>/`` at the root
of the checkout, where ``<hash>`` covers every source, header and flag, so
an edited source rebuilds and an unchanged tree loads what is there. They
are loaded with :mod:`ctypes`. Nothing here runs at import: the first
launch builds, so the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Element-type codes of the C entries (``rt::kF32``/``rt::kBF16`` in
#: ``csrc/common.cuh``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: Dict[str, ctypes.CDLL] = {}
_sms: Dict[int, int] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all(extra_flags: Sequence[str] = ()) -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built for the current sources,
    one ``nvcc`` per source, all started together. Returns ``{stem:
    library path}``. ``extra_flags`` (for instance ``("-Xptxas", "-v")``)
    reach the compilers but not the hash, so they must not change the
    code generated; each compiler's output is printed when they are
    given."""
    out_dir = BUILD_DIR / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    jobs = []
    for src in sources:
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
        jobs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed: List[str] = []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {src.name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, lib)
        if extra_flags:
            print(f"--- nvcc {src.name}\n{log}", flush=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {src.stem: out_dir / f"lib{src.stem}.so" for src in sources}


def load(stem: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu``, with ``argtypes`` set
    from ``signatures`` (every pointer and the stream as ``c_void_p``, so
    ctypes does not cut them to 32 bits) and ``restype`` int."""
    lib = _loaded.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[stem]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[stem] = lib
    return lib


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (asked once per device)."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def require_cuda_operands(what: str, *tensors: torch.Tensor) -> None:
    """Device, dtype and contiguity checks shared by the kernel wrappers:
    every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def dtype_code(what: str, *dtypes: torch.dtype) -> int:
    """The C element-type code of one shared dtype; raises on a mix or on
    a dtype the kernels do not take."""
    if len(set(dtypes)) != 1 or dtypes[0] not in DTYPE_CODES:
        raise ValueError(f"{what}: kernels take float32 or bfloat16 with one "
                         f"dtype for every value operand, got {dtypes}")
    return DTYPE_CODES[dtypes[0]]


def row_granule(t: torch.Tensor) -> int:
    """Elements per ``cp.async`` copy of the rows of a row-major 2-D
    ``t``: the widest of 16, 8 and 4 bytes that every row start is aligned
    to; 1 for a bf16 row of odd length, which a kernel then copies element
    by element with plain loads."""
    size = t.element_size()
    row = t.shape[1] * size
    for nbytes in (16, 8, 4):
        if nbytes >= size and row % nbytes == 0 and t.data_ptr() % nbytes == 0:
            return nbytes // size
    return 1
