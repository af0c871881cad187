"""The benchmark of ``mft_tpu_torch``: the 600-episode cross-domain eval's
throughput on the card, its per-layer readings, and the plain reference that
decides whether the timed episodes are right.  Run one cell from the repo
root with ``python3 -m portbench.run --workload <name> --seed <n> --seconds
<s> --trace <0|1>``; ``BENCHMARK.json`` lists the cells."""
