"""The benchmark of ``lili_om_tpu_torch``: one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload rot64.lap --seed 7 --seconds 30 --trace 0

Run from the root of a checkout on a machine with the CUDA devices the
cell asks for; prints one JSON line (the last line of standard output).
The program's build and kernel caches stay inside the checkout, and the
CPU libraries run on one thread."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
# one process with one host thread for the CPU libraries: the system is
# paced by its Python thread, and idle pool threads only add noise
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(HERE), str(ROOT)]

from lom_bench.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
