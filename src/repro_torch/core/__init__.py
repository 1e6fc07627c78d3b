"""AESPA core on PyTorch: the cost model, hardware database, workloads,
the single- and many-kernel schedulers and the DSE (numpy, copied from
``repro.core``), and the executors that run their schedules on the card
(``hetero_matmul``, with the stream executor of ``stream_exec``).
Re-exported as ``repro.core`` does, except that the function
``hetero_matmul`` stays in its module: ``repro_torch.core.hetero_matmul``
is the module."""
from repro_torch.core import (
    costmodel,
    dse,
    hetero_matmul,
    hwdb,
    scheduler,
    stream_exec,
    workloads,
)
from repro_torch.core.costmodel import (
    AcceleratorConfig,
    ClusterSpec,
    aespa_from_fractions,
    basic_cluster,
    homogeneous,
    homogeneous_hybrid,
    hybrid_cluster,
)
from repro_torch.core.costmodel import QueueStats, queue_stats
from repro_torch.core.hetero_matmul import (
    execute_many_kernel_schedule,
    execute_schedule,
    hetero_many_matmul,
)
from repro_torch.core.scheduler import (
    KernelSchedule,
    ManyKernelSchedule,
    Partition,
    PlacedPartition,
    Region,
    SchedulingPolicy,
    TaskAssignment,
    available_policies,
    get_policy,
    register_policy,
    schedule_many_kernels,
    schedule_single_kernel,
)
from repro_torch.core.stream_exec import StreamMesh
from repro_torch.core.workloads import TABLE_I, Workload

__all__ = [
    "costmodel", "dse", "hetero_matmul", "hwdb", "scheduler",
    "stream_exec", "workloads",
    "AcceleratorConfig", "ClusterSpec", "aespa_from_fractions",
    "basic_cluster", "homogeneous", "homogeneous_hybrid", "hybrid_cluster",
    "QueueStats", "queue_stats",
    "execute_many_kernel_schedule", "execute_schedule", "hetero_many_matmul",
    "KernelSchedule", "ManyKernelSchedule", "Partition",
    "PlacedPartition", "Region", "SchedulingPolicy", "TaskAssignment",
    "available_policies", "get_policy", "register_policy",
    "schedule_many_kernels", "schedule_single_kernel", "StreamMesh",
    "TABLE_I", "Workload",
]
