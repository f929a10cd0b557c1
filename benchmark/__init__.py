"""The benchmark of ``strajnet_tpu_torch`` on the H100: one cell of
``BENCHMARK.json`` a run (``python3 -m benchmark.run``)."""
