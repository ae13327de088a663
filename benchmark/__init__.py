"""The benchmark of ``stylemesh_tpu_torch``: a data-driven harness that
drives the port's training loop on CUDA cards.

``python3 benchmark/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``. A cell's
model configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json``, its correctness limits ``limits/<cell>.json``,
and every metric is read by ``metrics/<name>.py``: adding a cell or a
metric adds files and entries and edits none.

Nothing here imports JAX or the JAX package; :mod:`benchmark.reference`
imports nothing of the port either.
"""
