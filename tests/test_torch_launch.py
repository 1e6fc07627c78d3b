"""The port's launch layer (``repro_torch.launch.mesh`` and
``repro_torch.launch.dryrun``) against ``repro.launch``: the input specs
of all 40 (arch × shape) cells, ``skip_reason`` and ``TRAIN_TUNING``,
the production meshes on torch's fake backend, the one-cell multi-pod dry
run (a subprocess: the dry run starts a fake group of 512 ranks), and a
cell each of an MoE arch and an SSD arch (their experts and heads over
the model axis)."""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro.configs import all_archs, get_config
from repro.models import build as jbuild
from repro.models.config import SHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import (
    axis_sizes,
    batch_axes,
    make_mesh,
    make_production_mesh,
)
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import get_abstract_mesh, set_mesh, shutdown
from repro_torch.models import build as tbuild

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512
    host devices: the variable is restored at once (this process's JAX is
    already initialised; child processes must not inherit it)."""
    old = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def test_input_specs_equal_jax_batch_shapes_over_40_cells():
    n = 0
    for arch in all_archs():
        jm = jbuild(get_config(arch))
        for shape in SHAPES:
            want = {k: (tuple(v.shape), str(v.dtype))
                    for k, v in jm.batch_shapes(shape).items()}
            got = tdry.input_specs(arch, shape.name)
            assert all(t.is_meta for t in got.values())
            assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for k, t in got.items()} == want
            n += 1
    assert n == 40


def test_skip_reason_and_train_tuning_equal_jax(jdry):
    assert tdry.TRAIN_TUNING == jdry.TRAIN_TUNING
    for arch in all_archs():
        for shape in SHAPES:
            assert tdry.skip_reason(tbuild(tget_config(arch)), shape) == \
                jdry.skip_reason(jbuild(get_config(arch)), shape)


def test_production_meshes_on_the_fake_backend():
    assert not dist.is_initialized()
    try:
        m1 = make_production_mesh()
        assert list(m1.mesh.shape) == [16, 16]
        assert list(m1.mesh_dim_names) == ["data", "model"]
        assert axis_sizes(m1) == {"data": 16, "model": 16}
        assert list(batch_axes(m1)) == ["data"]
        assert dist.get_backend() == "fake"
        with pytest.raises(ValueError, match="512"):
            make_production_mesh(multi_pod=True)
        shutdown()
        m2 = make_production_mesh(multi_pod=True)
        assert list(m2.mesh.shape) == [2, 16, 16]
        assert list(m2.mesh_dim_names) == ["pod", "data", "model"]
        assert list(batch_axes(m2)) == ["pod", "data"]
        assert m2.size() == 512
        with pytest.raises(ValueError, match="process group of 512"):
            make_mesh((2, 4), ("data", "model"), "cpu")
        assert get_abstract_mesh() is None
        with set_mesh(m2):
            assert get_abstract_mesh() is m2
        assert get_abstract_mesh() is None
    finally:
        shutdown()
    assert not dist.is_initialized()


def test_one_cell_multipod_dryrun(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--mesh", "multipod",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / "multipod" / "whisper-base__decode_32k.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["devices"] == 512
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert sum(rec["collective"]["ops"].values()) > 0
    assert rec["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("arch,shape,mesh,devices", [
    ("olmoe-1b-7b", "decode_32k", "singlepod", 256),
    ("mamba2-370m", "long_500k", "multipod", 512),
])
def test_moe_and_ssd_cells_dryrun(tmp_path, arch, shape, mesh, devices):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / mesh / f"{arch}__{shape}.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["devices"] == devices
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert sum(rec["collective"]["ops"].values()) > 0
    assert rec["collective"]["ici_bytes_per_chip"] > 0
