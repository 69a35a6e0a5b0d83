"""Per-layer metrics, one reader a file (``<metric>.py``), found by the
metric's name in ``BENCHMARK.json``. Each defines ``UNIT``, ``MOVES``
(the end-to-end metric it should move) and ``read(rec)``, which returns
None when the run holds nothing for it to read. ``rec`` is the run's
record (``livebench/harness.py``): the window, its turns and rounds, the
KV tier's counter deltas, and in a traced run the profiled slice."""
