"""The benchmark's plain reference and its log generator.

A frozen copy of the port's plain paths, kept with the benchmark so that
later changes to the program do not move the yardstick: the feature
extractors, odometry, the sliding-window fusion, ICP, the pose graph and
their math, with every CUDA route removed (``ops/knn.py``,
``ops/segred.py``, ``ops/blocktri.py`` hold only the plain versions), the
system's glue around them (``stages.py``), and the simulator that makes
the benchmark's logs (``sim/``). It imports ``torch`` and ``numpy`` only.
"""
