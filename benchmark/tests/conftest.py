"""The harness's tests: on the CPU unless marked ``cuda`` (those decide in
the ``cuda`` fixture whether a card is present)."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell's own size and its kernels)")
    return torch.device("cuda")
