"""The port's one-card training launcher (``repro_torch.launch.train``)
against ``repro.launch.train``: the same flags with the same defaults and
choices, ``--mesh`` limited to one device, and ``main`` training reduced
configs on the CPU through the driver (enc-dec and VLM archs with their
frame and patch inputs)."""
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
    assert tlaunch.parse_mesh("1x1") == (1, 1)
    for spec in ("2x4", "1x2", "2"):
        with pytest.raises(NotImplementedError, match="sharding"):
            tlaunch.parse_mesh(spec)
    with pytest.raises(NotImplementedError, match="sharding"):
        tlaunch.main(["--mesh", "2x4"], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--steps", "1"])


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
