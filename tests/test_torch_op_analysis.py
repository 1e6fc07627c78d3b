"""The port's op analysis (``repro_torch.launch.op_analysis``) against
``repro.launch.hlo_analysis``: the ground truth that JAX's known failure
aims at (a loop of 7 sharded matmuls on a (2, 4) mesh, counted per device
exactly), ``shape_bytes``, the ring factors, the roofline's dominance and
``model_flops``; and the ``block_save`` remat policies, whose grads equal
``"block"``'s for a dense and a MoE arch."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.hlo_analysis as J
import repro_torch.configs as tconfigs
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.launch import op_analysis as H
from repro_torch.launch.mesh import set_mesh, shutdown
from repro_torch.models import build as tbuild
from repro_torch.models.layers import Axes, sc, uw


@pytest.fixture
def fake8():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        shutdown()


def test_ground_truth_sharded_matmul_loop(fake8):
    """JAX's ``test_ground_truth_scanned_matmul`` on DTensors: ws (7, 256,
    256) placed P(None, data, model), x (64, 256) P(data, model); each
    step ``c = sc(c @ uw(w), data, model)``. FLOPs per device are
    7·2·64·256²/8 exactly; two all-gathers a step (c over model, w over
    data), as JAX's test expects."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import NamedSharding, P, shard_tensor

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    n_layers, d, b = 7, 256, 64
    ws = shard_tensor(torch.empty(n_layers, d, d, device="meta"),
                      NamedSharding(mesh, P(None, "data", "model")))
    c = shard_tensor(torch.empty(b, d, device="meta"),
                     NamedSharding(mesh, P("data", "model")))
    axes = Axes(batch=("data",), sizes=(("data", 2), ("model", 4)))
    counter = H.OpCounter()
    with set_mesh(mesh), counter:
        for i in range(n_layers):
            lhs = sc(c, axes, "data", None)
            c = sc(lhs @ uw(ws[i], axes, None, "model"), axes, "data",
                   "model")
        c.sum()
    assert H.dot_flops(counter) == n_layers * 2 * b * d * d / 8
    st = H.collective_stats(counter)
    assert st.ops["all-gather"] == 2 * n_layers
    assert st.ops["all-reduce"] == 0 and st.ops["reduce-scatter"] == 0
    # c over model: (32, 256) f32 gathered from 4; w over data: (256, 64)
    # from 2.
    assert st.bytes_by_kind["all-gather"] == n_layers * (32 * 256 * 4
                                                         + 256 * 64 * 4)
    assert st.ici_bytes_per_chip == pytest.approx(
        n_layers * (32 * 256 * 4 * 3 / 4 + 256 * 64 * 4 / 2))
    mem = H.memory_bytes(counter)
    matmul_traffic = 7 * (64 * 256 + 256 * 256 / 4 + 64 * 256) * 4
    assert matmul_traffic * 0.5 <= mem <= matmul_traffic * 20


@pytest.mark.parametrize("s", ["f32[4,8]{1,0}", "bf16[2,3]",
                               "(f32[4], s32[2])", "pred[]",
                               "f8e4m3fn[16]", "c64[3]", "u4[8]"])
def test_shape_bytes_equal_jax(s):
    assert H.shape_bytes(s) == J.shape_bytes(s)


def test_tensor_bytes():
    assert H.tensor_bytes(torch.empty(4, 8)) == 128
    assert H.tensor_bytes(torch.empty(2, 3, dtype=torch.bfloat16)) == 12
    assert H.tensor_bytes(torch.empty(5, device="meta",
                                      dtype=torch.int64)) == 40


@pytest.mark.parametrize("kind,hlo_kind", [
    ("all-gather", "all-gather"), ("all-reduce", "all-reduce"),
    ("reduce-scatter", "reduce-scatter"), ("all-to-all", "all-to-all"),
    ("collective-permute", "collective-permute")])
def test_ring_factors_equal_jax(kind, hlo_kind):
    """One collective with a 1024-byte result over groups of 4, through
    JAX's HLO parser and the port's ring factors."""
    hlo = ("ENTRY %main (a: f32[8,32]) -> f32[8,32] {\n"
           "  %a = f32[8,32]{1,0} parameter(0)\n"
           f"  ROOT %c = f32[8,32]{{1,0}} {hlo_kind}(%a), channel_id=1, "
           "replica_groups=[2,4]<=[8], dimensions={1}\n"
           "}\n")
    want = J.collective_stats(hlo, 8)
    assert want.ops[kind] == 1
    assert H.ring_bytes(kind, 1024.0, 4) == pytest.approx(
        want.ici_bytes_per_chip)


def test_roofline_terms_and_dominance():
    rl = H.roofline_terms(H.PEAK_FLOPS, H.HBM_BW * 2, H.ICI_BW * 0.5)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == pytest.approx(
        (1.0, 2.0, 0.5))
    assert rl.dominant == "memory" and rl.bound_s == pytest.approx(2.0)
    assert H.roofline_terms(3 * H.PEAK_FLOPS, H.HBM_BW, 0).dominant == \
        "compute"
    assert H.roofline_terms(0, 0, H.ICI_BW).dominant == "collective"
    # The H100 SXM's constants, not the TPU's.
    assert (H.PEAK_FLOPS, H.HBM_BW, H.ICI_BW) == (989e12, 3.35e12, 450e9)
    assert (J.PEAK_FLOPS, J.HBM_BW, J.ICI_BW) != (H.PEAK_FLOPS, H.HBM_BW,
                                                 H.ICI_BW)


@pytest.mark.parametrize("args", [(10, 5, "train"), (10, 5, "serve"),
                                  (10, 5, "train", 2), (7, 3, "serve", 5)])
def test_model_flops_equal_jax(args):
    assert H.model_flops(*args) == J.model_flops(*args)


def test_counter_counts_local_ops_once():
    """On plain tensors each matmul counts once, with its own shapes;
    views move no bytes."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with H.OpCounter() as counter:
        y = (a @ b).t()
        y.unsqueeze(0)
        y.reshape(-1)                   # a transposed tensor: one copy
    assert H.dot_flops(counter) == 2 * 8 * 16 * 4
    assert counter.flops_by_dtype == {"float32": 2 * 8 * 16 * 4}
    rows = {op: n for _, n, op in H.memory_breakdown(counter)}
    assert rows == {"aten::mm": 1, "aten::clone": 1}
    assert H.memory_bytes(counter) == (8 * 16 + 16 * 4 + 8 * 4
                                       + 2 * 8 * 4) * 4


@pytest.mark.parametrize("arch,kw", [
    ("qwen2.5-3b", {}),
    ("olmoe-1b-7b", {"capacity_factor": 16.0})])
def test_block_save_grads_equal_block(arch, kw):
    """``block_save`` and ``block_save_moe`` save the tagged outputs and
    recompute the rest: on the CPU the grads are ``"block"``'s bit for
    bit."""
    rng = np.random.default_rng(3)
    grads = {}
    for remat in ("block", "block_save", "block_save_moe"):
        cfg = dataclasses.replace(tconfigs.get_reduced(arch), remat=remat,
                                  **kw)
        model = tbuild(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        if remat == "block":
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 16)).astype(np.int32))
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits, aux = model.forward(live, {"tokens": tokens})
        loss = logits.float().square().mean() + aux
        grads[remat] = torch.autograd.grad(loss, tree_leaves(live))
    for remat in ("block_save", "block_save_moe"):
        for a, b in zip(grads["block"], grads[remat]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
