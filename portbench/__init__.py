"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of AESPA.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything a cell is made of is found by name:

* ``configs/<config>.json``: an accelerator (its clusters, frozen) and the
  workloads it serves, with the reference module that judges its outputs;
* ``traffic/<mix>.json``: the task list of a traffic mix, read by the
  generator ``traffic/<kind>.py`` that its ``kind`` names;
* ``metrics/<metric>.py``: one reader per metric, end to end or per layer;
* ``references/<name>.py``: the plain reference and the control.

The yardstick (operand drawing, the work of a task, the peaks, the busy
union of a profile, the comparison) lives here and imports nothing of the
port; only the traffic generators call the port.
"""
