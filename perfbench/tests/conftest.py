"""Fixtures of the harness's tests: the repo's ``src`` and root on the path,
and the benchmark's configurations cut to the port's reduced sizes."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def reduced_decoder(cfg: dict) -> dict:
    """``cfg`` at the port's reduced sizes of its ``arch`` (the CPU tests'
    model), every option kept."""
    from repro_torch.configs import get_config
    c = get_config(cfg["arch"], reduced=True)
    return {**cfg, "hidden_size": c.d_model, "intermediate_size": c.d_ff,
            "num_hidden_layers": c.num_layers,
            "num_attention_heads": c.num_heads,
            "num_key_value_heads": c.num_kv_heads,
            "head_dim": c.resolved_head_dim, "vocab_size": c.vocab_size}


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
