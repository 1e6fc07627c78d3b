"""The port's training launcher (``repro_torch.launch.train``) against
``repro.launch.train``: the same flags with the same defaults and choices,
``--mesh`` parsed to JAX's axis names, and ``main`` training reduced
configs on the CPU through the driver on a mesh of one device (enc-dec and
VLM archs with their frame and patch inputs). The (2, 4) mesh runs on 8
ranks in ``tests/test_torch_sharded.py``."""
import argparse
import os

import numpy as np
import pytest

import repro.launch.train as jlaunch
from repro_torch.checkpoint import latest_step
from repro_torch.launch import train as tlaunch


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser JAX's ``main`` builds (it stops at ``parse_args``)."""
    def stop(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as got:
        jlaunch.main()
    monkeypatch.undo()
    return got.value.parser


def flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices)
            for a in parser._actions}


def test_parser_flags_and_defaults_equal_jax(monkeypatch):
    want = flags(jax_parser(monkeypatch))
    got = flags(tlaunch.build_parser())
    assert got == want
    args = tlaunch.build_parser().parse_args([])
    assert (args.arch, args.preset, args.mesh, args.steps, args.batch,
            args.seq, args.microbatches, args.compress) == (
        "qwen1.5-0.5b", "reduced", "1x1", 20, 8, 64, 1, "none")


def test_mesh_is_one_device():
    """One process is a mesh of one device: ``--mesh 2x4`` needs 8 ranks
    (``torchrun``), and without ``device="cpu"`` the mesh is the card's."""
    import torch.distributed as dist

    assert tlaunch.parse_mesh("1x1") == ((1, 1), ("data", "model"))
    assert tlaunch.parse_mesh("2x4") == ((2, 4), ("data", "model"))
    assert tlaunch.parse_mesh("2") == ((2,), ("data",))
    assert tlaunch.parse_mesh("2x2x2") == ((2, 2, 2),
                                           ("pod", "data", "model"))
    with pytest.raises(ValueError, match="8 ranks"):
        tlaunch.main(["--mesh", "2x4"], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--steps", "1"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,steps,extra", [
    ("qwen1.5-0.5b", 4, ["--compress", "int8", "--microbatches", "2"]),
    ("whisper-base", 2, []),      # frames
    ("internvl2-1b", 2, []),      # frontend patches
])
def test_main_trains_reduced_on_the_cpu(tmp_path, capsys, arch, steps,
                                        extra):
    ck = str(tmp_path / "ck")
    report = tlaunch.main(["--arch", arch, "--steps", str(steps), "--batch",
                           "4", "--seq", "16", "--ckpt-dir", ck, *extra],
                          device="cpu")
    assert report.steps_run == steps and report.restarts == 0
    assert np.isfinite(report.final_metrics["loss"])
    assert report.final_metrics["loss"] > 0
    assert latest_step(ck) == steps
    assert os.path.exists(os.path.join(ck, f"step_{steps:08d}.npz"))
    assert f"steps={steps} restarts=0" in capsys.readouterr().out
