"""The benchmark of ``lqg_tpu_torch`` on one NVIDIA H100: the hierarchical
data fit's NUTS, MAP loop and value+grad, checked against a plain
reference.  ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the
repository's root names the cells."""
