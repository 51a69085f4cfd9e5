"""The benchmark of hdk_tpu_torch: query streams over generated tables on
one CUDA card.

``python3 olap_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one deployment, traffic mix,
reference or per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``  the deployment: source, schema, scale;
* ``data/<generator>.py``    its seeded generator (numpy);
* ``reference/<module>.py``  plain numpy answers of its query shapes;
* ``mixes/<traffic>.json``   the query stream (SQL or builder calls);
* ``limits/<cell>.json``     the limits of the numbers ``correct`` compares;
* ``metrics/<metric>.py``    one reader per per-layer metric.

Nothing here imports jax or the JAX package, and ``reference/`` imports
nothing of the port.
"""
