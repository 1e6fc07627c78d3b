"""The yardstick's arithmetic: operands drawn from the seed, the
effectual MACs and bytes of a task against a brute-force count, and the
bound."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from portbench import mix, operands, work


def brute_macs(a: np.ndarray, b: np.ndarray) -> int:
    m, k = a.shape
    n = b.shape[1]
    return sum(1 for i, kk, j in itertools.product(range(m), range(k),
                                                   range(n))
               if a[i, kk] != 0 and b[kk, j] != 0)


@pytest.mark.parametrize("m,k,n,d_mk,d_kn", [
    (7, 5, 6, 0.3, 0.5), (4, 9, 3, 1.0, 0.2), (6, 6, 6, 0.05, 1.0),
    (1, 8, 1, 0.5, 0.5), (5, 3, 7, 0.0, 0.4)])
def test_effectual_macs_against_brute_force(m, k, n, d_mk, d_kn):
    gen = torch.Generator().manual_seed(7)
    a = operands.draw(m, k, d_mk, gen, torch.float32)
    b = operands.draw(k, n, d_kn, gen, torch.float32)
    w = work.task_work(a, b)
    assert w.macs == brute_macs(a.numpy(), b.numpy())
    assert w.flops == 2 * w.macs
    assert w.nbytes == 4 * (m * k + k * n + m * n)


def test_draw_holds_the_exact_count_and_follows_the_seed():
    def one(seed):
        gen = torch.Generator().manual_seed(seed)
        return operands.draw(40, 30, 0.07, gen, torch.float32)

    a, again, other = one(2 ** 31 + 5), one(2 ** 31 + 5), one(3)
    assert int((a != 0).sum()) == operands.nonzeros(40, 30, 0.07) == 84
    assert int((other != 0).sum()) == 84
    assert torch.equal(a, again) and not torch.equal(a, other)
    dense = operands.draw(5, 4, 1.0, torch.Generator().manual_seed(1),
                          torch.float32)
    assert bool((dense != 0).all())


def test_draw_pairs_keep_task_shapes():
    tasks = [mix.Task("x", 3, 4, 5, 0.5, 0.5), mix.Task("y", 2, 2, 2, 1, 1)]
    pairs = operands.draw_pairs(tasks, torch.Generator().manual_seed(0),
                                torch.float32)
    assert [(tuple(a.shape), tuple(b.shape)) for a, b in pairs] == [
        ((3, 4), (4, 5)), ((2, 2), (2, 2))]


def test_bound_is_the_longer_of_operations_and_bytes():
    by_ops = work.Work(macs=10 ** 12, nbytes=10 ** 6, dtype=torch.float32)
    by_bytes = work.Work(macs=10, nbytes=10 ** 10, dtype=torch.float32)
    assert work.bound_s([by_ops]) == pytest.approx(2e12 / 495e12)
    assert work.bound_s([by_bytes]) == pytest.approx(1e10 / 3.35e12)
    both = work.bound_s([by_ops, by_bytes])
    assert both == pytest.approx(max(2e12 / 495e12,
                                     (1e6 + 1e10) / 3.35e12))


def test_table_one_queue_bound():
    """The Table I queue at its frozen dims and nominal densities: 8.745
    GB, bound by bytes at 2.610 ms."""
    from portbench.spec import ROOT, Bench

    cfg = Bench(ROOT).config("aespa_opt")
    nbytes = sum(4 * (t.m * t.k + t.k * t.n + t.m * t.n)
                 for t in (mix.task(n, {}, cfg) for n in cfg["suite"]))
    assert nbytes == 8744691008
    assert nbytes / work.PEAK_BYTES * 1e3 == pytest.approx(2.6104, abs=1e-4)
