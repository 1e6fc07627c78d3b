"""The absorbed-attention kernel's share of its roofline in the traced
window, in percent: the latent bytes the window's decode steps must read
at HBM's peak (``portbench.work.PEAK_BYTES``) over the device time of the
kernel's launches (device events named ``rt::mla_``: its split and merge
kernels).

The bytes are counted as ``portbench.lm_work_mla.step_work`` counts the
cache's: each key a row attends, ``[0, pos]``, read once in each layer,
its latent ``c`` (512) and rope key ``k_pe`` (64) in bfloat16, the only
widths and type the kernel takes. The program's counters give the keys
and the layers, a step: ``repro.mla.positions`` (keys a layer) and
``repro.mla.attend_launches`` (the kernel's launches, one a layer), which
the profile carries as marks named ``counter:<name>=<value>``. None where
the window holds no launch of the kernel or no such marks, as in a
program without the kernel."""
from portbench.work import PEAK_BYTES

KERNEL = "rt::mla_"
MARK = "counter:"
POSITIONS, LAUNCHES = "repro.mla.positions", "repro.mla.attend_launches"
#: Bytes of one key in one layer: c and k_pe, bfloat16.
KEY_BYTES = (512 + 64) * 2


def _marks(tr, name):
    """The values of the counter ``name``'s marks in the window, in
    time order."""
    head = f"{MARK}{name}="
    return [float(e.name[len(head):]) for e in sorted(
        tr.host, key=lambda e: e.start_us) if e.name.startswith(head)
        and tr.start_us <= e.start_us <= tr.end_us]


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units:
        return None
    kernel_us = sum(min(e.end_us, tr.end_us) - max(e.start_us, tr.start_us)
                    for e in tr.device if KERNEL in e.name
                    and e.end_us > tr.start_us and e.start_us < tr.end_us)
    keys, layers = _marks(tr, POSITIONS), _marks(tr, LAUNCHES)
    if kernel_us <= 0 or not keys or len(keys) != len(layers):
        return None
    nbytes = KEY_BYTES * sum(k * n for k, n in zip(keys, layers))
    return 100.0 * nbytes / PEAK_BYTES / (kernel_us / 1e6)
