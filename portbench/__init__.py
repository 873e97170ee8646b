"""The benchmark of ``grayskull_tpu_torch`` on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything
that belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own, found by its name:

* ``configs/<config>.json``: the deployment (entry, parameters, frames, content);
* ``drivers/<config>.py``: how to call the port's entry, which output to read back;
* ``reference/<config>.py``: the plain reference the outputs are held to;
* ``workloads/<cell>.json``: the traffic (batch, batches in flight, pool);
* ``metrics/<metric>.py``: the reader of one per-layer metric.

A metric named ``<quantity>.<family>`` (``frames_per_s.sync``,
``device_idle_pct.sync``) is the quantity of ``<quantity>``, reported by a
family of cells under bounds of its own, and read by ``metrics/<quantity>.py``.

Nothing here imports JAX or the JAX package.
"""
