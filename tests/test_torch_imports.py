"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports jax or the JAX package, and its entry points never drop quietly
to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]

# `import jax`, `from jax...`, `import repro`, `from repro.x` — but not
# repro_torch — and the same names handed to import_module / __import__
STATIC = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)\b(?!_)",
                    re.MULTILINE)
DYNAMIC = re.compile(r"(?:import_module|__import__)\(\s*f?['\"]"
                     r"(?:jax|repro)\b(?!_)")


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/kernels/ops.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    text = path.read_text()
    assert not STATIC.findall(text), STATIC.findall(text)
    assert not DYNAMIC.findall(text), DYNAMIC.findall(text)


def test_port_imports_and_serves_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "import repro_torch, repro_torch.models, repro_torch.serving\n"
        "import repro_torch.kernels.ops\n"
        "from repro_torch.serving import ModelStageServer\n"
        "st = ModelStageServer('s', 'qwen3-0.6b', seq_len=8, reduced=True,\n"
        "                      device='cpu')\n"
        "out = st.process(torch.zeros(2, 8, dtype=torch.int32))\n"
        "assert out.shape == (2,) and out.dtype == torch.int32\n"
        "st = ModelStageServer('x', 'xlstm-1.3b', seq_len=8, reduced=True,\n"
        "                      device='cpu')\n"
        "out = st.process(torch.zeros(2, 8, dtype=torch.int32))\n"
        "assert out.shape == (2,) and out.dtype == torch.int32\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import Transformer\n"
        "m = Transformer(get_config('starcoder2-3b', reduced=True),\n"
        "                device='cpu', dtype=torch.float32)\n"
        "_, c = m.serve_prefill(torch.zeros(1, 8, dtype=torch.int32),\n"
        "                       cache_len=10)\n"
        "lg, c = m.serve_decode(torch.zeros(1, dtype=torch.int32), c)\n"
        "assert lg.shape == (1, 512) and c.pos == 9\n"
        "m = Transformer(get_config('jamba-v0.1-52b', reduced=True),\n"
        "                device='cpu', dtype=torch.float32)\n"
        "_, c = m.serve_prefill(torch.zeros(1, 8, dtype=torch.int32),\n"
        "                       cache_len=10)\n"
        "lg, c = m.serve_decode(torch.zeros(1, dtype=torch.int32), c)\n"
        "assert lg.shape == (1, 512) and c.pos == 9\n"
        "import repro_torch.core.allocator, repro_torch.core.hierarchy\n"
        "import repro_torch.sim, repro_torch.launch.serve\n"
        "from repro_torch.core import (RTX_2080TI, CamelotAllocator,\n"
        "                              PipelinePredictor, SAConfig)\n"
        "from repro_torch.sim import camelot_suite\n"
        "p = camelot_suite()['img-to-img']\n"
        "pred = PipelinePredictor.from_graph(p, RTX_2080TI, batches=(1, 4))\n"
        "res = CamelotAllocator(p, pred, RTX_2080TI, 1,\n"
        "                       sa=SAConfig(iterations=60, seed=0)\n"
        "                       ).solve_max_load(4)\n"
        "assert res.feasible and res.objective > 0\n"
        "assert sys.modules['jax'] is None and sys.modules['repro'] is None\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_device_none_raises_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serving import ModelStageServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelStageServer("s", "qwen3-0.6b", seq_len=8, reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(get_config("qwen3-0.6b", reduced=True))


def test_unported_architecture_raises():
    from repro_torch.configs import get_config
    with pytest.raises(KeyError, match="not ported"):
        get_config("chameleon-34b")
