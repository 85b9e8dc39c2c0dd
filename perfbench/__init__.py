"""perfbench: the benchmark of the PyTorch/CUDA port, ``vimoclip_tpu_torch``.

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, on the machine it is started on,
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with its limit.

Everything is found by name: a cell's configuration file (``configs/``), its
traffic mix (``traffic/<traffic>.json``, which names its driver in
``drivers/``), its limits (``limits/<cell>.json``) and every metric's reader
(``metrics/<metric>.py``). The references that decide ``correct`` are in
``reference/``. Nothing here imports ``jax`` or the JAX package."""
