"""The benchmark of ``vgd_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric or kernel sits in a file of its own, found by its name:

* ``configs/<config>.json``: the configuration as it is run;
* ``workloads/<cell>.json``: a cell's limits of ``correct`` and traced
  steps;
* ``traffic/<traffic>.json``: a traffic mix's parameters, naming its
  driver;
* ``drivers/<driver>.py``: the generator of a traffic kind (set-up, the
  measured window, the readings that decide ``correct``);
* ``families/<family>.py``: how the program under test is built for a
  family;
* ``reference/<family>.py``: the plain f32 PyTorch reference;
* ``flops/<family>.py``: model FLOPs from the configuration's shapes;
* ``kernels/<kernel>.py``: a kernel's name pattern and the operations and
  bytes of its launches;
* ``metrics/<metric>.py``: one reader for each per-layer metric.

``readings.py`` gives, on the card, the readings that the limits of
``correct`` were set from (sound runs, the control, the faults that
``faults.py`` plants in the program); ``tests/`` holds the benchmark's
own tests.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or ``vgd_tpu``; the
reference imports nothing of ``vgd_tpu_torch``.
"""
