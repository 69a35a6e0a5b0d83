"""livebench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

Run one cell with ``python3 livebench/run.py``; ``README.md`` says how
to add a configuration, a traffic mix, a cell or a per-layer metric.
"""
