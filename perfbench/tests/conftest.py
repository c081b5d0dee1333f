"""Fixtures of the harness's tests: the repo's ``src`` and root on the path,
and the look for a card.  The configurations cut to the port's reduced
sizes are ``perfbench.util.reduced``'s, by each model's family."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
