"""The port's sharding specs (``repro_torch.sharding``) against
``repro.sharding``: ``param_pspecs`` entry for entry for the ten archs'
full configs on both production meshes' axis sizes (abstract params on
both sides: JAX's ``eval_shape``, the port's ``meta`` tensors), and
``cache_pspecs`` batch-sharded and sequence-sharded; ``to_placements`` on
tuple axes and ``shard_tensor``'s slices on a fake 8-rank mesh; the
``moe``, ``ssm`` and ``recurrent`` archs on a mesh of one device (gloo)
equal to their unsharded forward; and the two signatures the port once
had wrong (``restore``'s and ``TrainDriver.run``'s ``shardings``)."""
import inspect

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import repro.checkpoint as jckpt
import repro.configs as jconfigs
import repro.runtime.driver as jdriver
import repro.sharding as jsharding
import repro_torch.checkpoint as tckpt
import repro_torch.configs as tconfigs
import repro_torch.runtime.driver as tdriver
from repro.models import build as jbuild
from repro_torch import sharding as tsharding
from repro_torch.common.pytree import tree_leaves_with_path
from repro_torch.launch.mesh import make_mesh, shutdown
from repro_torch.models import build as tbuild
from repro_torch.models.layers import Axes

SIZES = {"singlepod": {"data": 16, "model": 16},
         "multipod": {"pod": 2, "data": 16, "model": 16}}


def _jkey(path):
    return tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))
                 for k in path)


def jax_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_jkey(p): tuple(s) for p, s in leaves}


def port_specs(tree):
    return {p: tuple(s) for p, s in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_param_pspecs_equal_jax_full_configs(arch):
    jparams = jbuild(jconfigs.get_config(arch)).abstract_params()
    tparams = tbuild(tconfigs.get_config(arch)).abstract_params()
    assert all(t.is_meta for _, t in tree_leaves_with_path(tparams))
    for sizes in SIZES.values():
        want = jax_specs(jsharding.param_pspecs(jparams, sizes))
        got = port_specs(tsharding.param_pspecs(tparams, sizes))
        assert got == want
        assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("arch,batch", [
    ("gemma3-1b", 32), ("gemma3-1b", 3), ("whisper-base", 32),
    ("recurrentgemma-2b", 32), ("mamba2-370m", 32)])
def test_cache_pspecs_equal_jax(arch, batch):
    jm = jbuild(jconfigs.get_reduced(arch))
    tm = tbuild(tconfigs.get_reduced(arch))
    enc = 8 if arch == "whisper-base" else 0
    jcache = jax.eval_shape(lambda: jm.init_cache(batch, 16, enc_len=enc))
    tcache = tm.init_cache(batch, 16, enc_len=enc, device="meta")
    for name, sizes in SIZES.items():
        baxes = ("pod", "data") if name == "multipod" else ("data",)
        for seq in (False, True):
            want = jax_specs(jsharding.cache_pspecs(jcache, baxes, sizes,
                                                    seq_shard=seq))
            got = port_specs(tsharding.cache_pspecs(tcache, baxes, sizes,
                                                    seq_shard=seq))
            assert got == want


@pytest.fixture
def fake8():
    """A fake process group of 8 ranks, this process rank 5, torn down
    after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        yield
    finally:
        shutdown()


def test_to_placements_and_shard_tensor_on_tuple_axes(fake8):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    assert list(mesh.get_coordinate()) == [1, 0, 1]
    P = tsharding.P
    assert tsharding.to_placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert tsharding.to_placements(P(None, ("data",)), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert tsharding.to_placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="major first"):
        tsharding.to_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="names axis"):
        tsharding.to_placements(P("seq"), mesh)
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    dt = tsharding.shard_tensor(t, tsharding.NamedSharding(
        mesh, P(("pod", "data"), "model")))
    # pod 1, data 0: the third of four row blocks; model 1: the second
    # half of the columns.
    assert torch.equal(dt.to_local(), t[4:6, 3:6])
    assert dt.shape == t.shape
    with pytest.raises(ValueError, match="split"):
        tsharding.shard_tensor(torch.zeros(6, 6), tsharding.NamedSharding(
            mesh, P(("pod", "data"))))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_unsharded_families_run_on_a_one_device_mesh(arch):
    """On a mesh of one device the placements are all Replicate, so the
    MoE dispatch and the scans run as they are: the logits equal the
    unsharded forward's bit for bit. (On 8 ranks they raise:
    tests/test_torch_sharded.py.)"""
    cfg = tconfigs.get_reduced(arch)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))}
    plain, _ = model.forward(params, batch)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    try:
        axes = Axes(batch=("data",), sizes=(("data", 1), ("model", 1)))
        shardings = tsharding.named_shardings(
            tsharding.param_pspecs(params, {"data": 1, "model": 1}), mesh)
        sharded, _ = model.forward(tsharding.distribute(params, shardings),
                                   batch, axes)
        assert torch.equal(sharded.full_tensor(), plain)
    finally:
        shutdown()
    assert not dist.is_initialized()


@pytest.mark.parametrize("jfn,tfn,last", [
    (jckpt.restore, tckpt.restore, "shardings"),
    (jdriver.TrainDriver.run, tdriver.TrainDriver.run, "shardings"),
])
def test_shardings_signatures_match_jax(jfn, tfn, last):
    """JAX's parameters in JAX's order, ``shardings`` last, so a call
    written for ``repro`` binds the same parameters by keyword or by
    position; the port's ``device`` comes after them."""
    jparams = list(inspect.signature(jfn).parameters)
    tparams = list(inspect.signature(tfn).parameters)
    assert jparams[-1] == last
    assert tparams == jparams + ["device"]
