"""The benchmark of ``riak_ensemble_tpu_torch`` on one or more H100 cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell
needs is found by name: ``configs/<config>.json`` (the deployment),
``traffic/<mix>.json`` (the parameters of the one traffic generator,
:mod:`perfbench.traffic`) and ``metrics/<metric>.py`` (the reader of one
per-layer metric).  The yardstick lives here: the generator, the plain
reference (:mod:`perfbench.reference`), F1's byte count
(:mod:`perfbench.f1_bytes`), the trace reduction (:mod:`perfbench.trace`)
and the comparison that decides ``correct``.
"""
