"""The benchmark's own tests: run with ``python -m pytest tpgbench/tests``
from the repository root.  They need no card; tests marked ``cuda`` run
the command on one and skip without it."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cut size the CPU plain path runs in seconds: 2 links, 16-frame batches
# (longer than a TPSet window's reach back), 4 batches of raw retention
CUT = {"links": 2, "frames_per_batch": 16, "raw_capacity_frames": 64}


@pytest.fixture
def cut():
    return dict(CUT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
