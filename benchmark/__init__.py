"""The benchmark of the PyTorch/CUDA port (``tekken_tpu_torch``).

Run one cell from the root of a checkout:

    python3 -m benchmark.run --workload corpus.multilingual --seed 7 \
        --seconds 10 --trace 0

``BENCHMARK.json`` names the cells; each configuration, traffic mix,
entry point and per-layer metric is a file of its own under this folder,
found by its name (``core/spec.py``).
"""
