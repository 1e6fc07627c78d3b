"""Per-device accounting of a traced step: FLOPs, bytes, collective
traffic and roofline terms — the counterpart of
``repro.launch.hlo_analysis``.

There is no HLO in torch. The program is the ops that DTensor dispatches
on each rank's local shards, and :class:`OpCounter` counts them as they
run: a ``TorchDispatchMode`` that declines DTensor-level ops
(``NotImplemented``), so DTensor first turns each into local ops and
functional collectives, which the counter then sees with local shapes (a
counter above DTensor's dispatch, such as a bare ``FlopCounterMode``,
counts the global op). The shape inference that DTensor runs on global
fake tensors is not counted. Ops outside DTensor (the flash
``autograd.Function`` on local slices, the context-parallel merge) are
local already. Under the
fake process group of the production mesh with ``meta`` tensors the
counter is a dry run; on the card with real tensors it counts what ran.

JAX's functions and theirs here:

* ``dot_flops``: Σ over matmuls and convolutions of their FLOPs
  (``torch.utils.flop_counter``'s formulas, 2·M·N·K for a product) on
  local shapes; :attr:`OpCounter.flops_by_dtype` splits them by the
  operands' dtype.
* ``collective_breakdown``/``collective_stats``: the functional
  collectives by kind, their result bytes and per-chip link bytes with
  JAX's ring factors, unchanged. The key ``ici_bytes_per_chip`` is kept;
  on the H100 it counts NVLink bytes.
* ``memory_breakdown``/``memory_bytes``: bytes read and written by every
  op that makes a tensor (views are free) on local shards. Eager torch
  writes every op's result to memory, so elementwise ops are charged,
  where JAX charges only XLA's fusion boundaries.
* ``shape_bytes``: the dtype table, for HLO-style type strings;
  :func:`tensor_bytes` for tensors.
* ``Roofline``/``roofline_terms``: the H100 SXM's constants in place of
  the TPU's.
* ``model_flops``: a copy.
* ``split_computations`` and ``loop_multipliers`` have no counterpart:
  eager dispatch runs, and so counts, every layer's ops, where XLA's while
  body is counted once and needs the trip count.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional collectives (``_c10d_functional::<name>``) by JAX's kind.
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

#: ops that allocate without writing, or are views that the schema does
#: not mark as such (their bytes are not traffic).
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "wait_tensor", "_unsafe_view",
               "lift_fresh"}


def shape_bytes(shape_str: str) -> int:
    """Total bytes of every shape token in an HLO result type string."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` (lists, tuples, dicts) in order. A loop, not
    a recursive closure: a closure that calls itself is a reference cycle,
    which would keep every counted op's tensors alive until Python's cycle
    collector ran."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def ring_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-chip link bytes of one collective whose result is ``nbytes``
    over ``n`` participants (ring algorithms; JAX's factors)."""
    if kind == "all-gather":
        return nbytes * (n - 1) / n          # result = gathered
    if kind == "all-reduce":
        return nbytes * 2 * (n - 1) / n      # RS + AG
    if kind == "reduce-scatter":
        return nbytes * (n - 1)              # result = 1/n input
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    return nbytes


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class OpCounter(TorchDispatchMode):
    """Counts the local ops of what runs under it (see the module note).

    ``flops``, ``flops_by_dtype``, ``bytes_by_op`` ({op: [bytes, count]}),
    ``collectives`` (rows (kind, result bytes, group size, op)), and an
    estimate of the peak of live intermediate bytes (each result counted
    from its op until the tensor is freed)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.bytes_by_op: Dict[str, List[float]] = defaultdict(
            lambda: [0.0, 0])
        self.collectives: List[Tuple[str, float, int, str]] = []
        self.live = 0
        self.peak_live = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs each new op once on global
        # fake tensors to learn its output's shape: no op of the program.
        if not any(isinstance(t, FakeTensor) for t in _tensors(args)):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = func.name()
        base = name.split("::")[-1]
        if name.startswith("_c10d_functional::"):
            kind = _FUNCOL_KIND.get(base)
            if kind is not None:
                nbytes = sum(tensor_bytes(t) for t in _tensors(out))
                self.collectives.append((kind, float(nbytes),
                                         _group_size(args), base))
            return
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            dt = _tensors(args)[0].dtype if _tensors(args) else None
            self.flops_by_dtype[str(dt).replace("torch.", "")] += f
        outs = _tensors(out)
        if base in _NO_TRAFFIC or not outs:
            return
        returns = func._schema.returns
        if returns and returns[0].alias_info is not None \
                and not returns[0].alias_info.is_write:
            return                                   # a view: free
        written = sum(tensor_bytes(t) for t in outs)
        read = sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
        row = self.bytes_by_op[name]
        row[0] += written + read
        row[1] += 1
        if returns and returns[0].alias_info is None:
            for t in outs:
                n = tensor_bytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak_live = max(self.peak_live, self.live)


def dot_flops(counter: OpCounter) -> float:
    """Per-device matmul (and convolution) FLOPs of the counted ops."""
    return counter.flops


def memory_breakdown(counter: OpCounter) -> List[Tuple[float, int, str]]:
    """Rows (bytes read + written, count, op), largest first."""
    rows = [(b, int(n), op) for op, (b, n) in counter.bytes_by_op.items()]
    rows.sort(key=lambda r: -r[0])
    return rows


def memory_bytes(counter: OpCounter) -> float:
    """Per-device bytes read and written by the counted ops."""
    return float(sum(b for b, _, _ in memory_breakdown(counter)))


@dataclasses.dataclass
class CollectiveStats:
    """Per-op-kind result bytes and estimated per-chip link traffic."""

    ops: Dict[str, int]
    bytes_by_kind: Dict[str, float]
    ici_bytes_per_chip: float

    @property
    def total_result_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_breakdown(counter: OpCounter
                         ) -> List[Tuple[float, str, float, int, str]]:
    """Itemised per-chip link bytes: rows (link bytes, kind, result bytes,
    group size, op), largest first."""
    rows = [(ring_bytes(kind, nbytes, n), kind, nbytes, n, op)
            for kind, nbytes, n, op in counter.collectives]
    rows.sort(key=lambda r: -r[0])
    return rows


def collective_stats(counter: OpCounter) -> CollectiveStats:
    """Collectives by kind: count, result bytes, and per-chip link bytes
    with the ring factors."""
    ops: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    raw: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    link = 0.0
    for kind, nbytes, n, _ in counter.collectives:
        ops[kind] += 1
        raw[kind] += nbytes
        link += ring_bytes(kind, nbytes, n)
    return CollectiveStats(ops=ops, bytes_by_kind=raw,
                           ici_bytes_per_chip=link)


# -------------------------------------------------------------- roofline
#: NVIDIA H100 SXM (per card), NVIDIA's data sheet, dense rates.
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
ICI_BW = 450e9               # NVLink 4 bytes/s per direction


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    ici_bytes_per_chip: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   ici_bytes_per_chip: float) -> Roofline:
    return Roofline(
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=ici_bytes_per_chip / ICI_BW,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        ici_bytes_per_chip=ici_bytes_per_chip,
    )


def model_flops(param_count: int, tokens: float, kind: str,
                active_param_count: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (fwd-only); MoE uses N_active."""
    n = active_param_count if active_param_count else param_count
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
