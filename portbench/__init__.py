"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line.  Everything that belongs to one configuration, one
traffic mix, one per-layer metric or one cell's limits is a file of its
own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<mix>.json``: the traffic mix, read by ``gen/<kind>.py``;
* ``metrics/<metric>.py``: the per-layer metric's reader;
* ``limits/<cell>.json``: the limits of the cell's correctness check;
* ``counts/<kernel>.py``: a kernel's operations and bytes from shapes.

``reference/`` is the plain float32 PyTorch the check compares with; it
imports nothing of the port.
"""
