"""The benchmark of ``hakai_tpu_torch``: whole simulations through
``run()``, measured and checked against a plain reference
(``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; see ``PERF.md``)."""
