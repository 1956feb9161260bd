"""The benchmark harness of ``lili_om_tpu_torch``: a seeded log replayed
through ``LiliOmSystem`` in a timed window (``window.py``), the readings of
the window and of a traced slice (``trace.py``, ``roofline.py``), the
comparison with the plain reference that decides ``correct``
(``check.py``), and the registry that finds each configuration, traffic
mix and per-layer metric by its name in ``BENCHMARK.json`` (``registry.py``).

Nothing here imports the program at import time; the program is imported
by ``program.py`` when a run builds its system.
"""
