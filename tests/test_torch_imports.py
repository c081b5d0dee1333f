"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py,
nor an example twin ``examples/*_torch.py``) imports jax or the JAX
package, and its entry points never drop quietly to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE_TWINS = sorted((ROOT / "examples").glob("*_torch.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + EXAMPLE_TWINS

# `import jax`, `from jax...`, `import repro`, `from repro.x` — but not
# repro_torch — and the same names handed to import_module / __import__
STATIC = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)\b(?!_)",
                    re.MULTILINE)
DYNAMIC = re.compile(r"(?:import_module|__import__)\(\s*f?['\"]"
                     r"(?:jax|repro)\b(?!_)")


KERNEL_SOURCES = sorted((ROOT / "src" / "repro_torch" / "kernels" / "csrc")
                        .glob("*.cu"))
# the tests that hold the recurrent backwards to the reference (CPU) and
# the card-only tests (no jax: the card's host has none)
RECURRENT_BWD_TESTS = ROOT / "tests" / "test_torch_recurrent_bwd.py"
CUDA_TESTS = ROOT / "tests" / "test_torch_cuda.py"


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/kernels/ops.py" in names
    assert {p.name for p in KERNEL_SOURCES} >= {
        "flash_attention.cu", "flash_attention_bwd.cu", "mlstm_chunk.cu",
        "mlstm_chunk_bwd.cu", "decode_attention.cu", "ssm_scan.cu",
        "ssm_scan_bwd.cu"}
    assert RECURRENT_BWD_TESTS.exists() and CUDA_TESTS.exists()
    assert {"src/repro_torch/core/anneal_torch.py"} | {
        f"src/repro_torch/launch/{m}.py" for m in (
            "roofline", "mesh", "sharding", "dryrun")} <= names
    assert "chip_smoke.py" in names
    assert {p.name for p in EXAMPLE_TWINS} == {
        "quickstart_torch.py", "serve_pipeline_torch.py",
        "artifact_suite_torch.py", "train_small_torch.py"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    text = path.read_text()
    assert not STATIC.findall(text), STATIC.findall(text)
    assert not DYNAMIC.findall(text), DYNAMIC.findall(text)


@pytest.mark.parametrize("path", KERNEL_SOURCES, ids=lambda p: p.name)
def test_kernel_source_names_the_tpu_kernel_it_ports(path):
    """Each kernel's note opens by naming the TPU kernel (file and
    function or line) it replaces, or whose gradient it is."""
    head = path.read_text().split("#include")[0]
    assert re.search(r"src/repro/kernels/\w+\.py:", head), path.name


def test_cuda_tests_import_no_jax():
    text = CUDA_TESTS.read_text()
    assert not STATIC.findall(text), STATIC.findall(text)
    assert "jax" in RECURRENT_BWD_TESTS.read_text()


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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(get_config("whisper-medium"))


def test_unported_architecture_raises():
    """A name that neither package registers (every architecture of the
    reference is ported)."""
    from repro_torch.configs import get_config
    with pytest.raises(KeyError, match="unknown architecture 'llama-7b'"):
        get_config("llama-7b")


def test_port_registers_every_reference_architecture():
    import repro.configs as ref_configs
    import repro_torch.configs as port_configs
    assert set(port_configs.ARCH_IDS) == set(ref_configs.ARCH_IDS)
    for arch in port_configs.ARCH_IDS:
        assert port_configs.get_config(arch).name == arch


def test_example_twins_run_with_jax_and_repro_blocked():
    """Each twin's functions, imported and run on the CPU (reduced models
    where it serves any) with jax and the JAX package blocked."""
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "def load(name):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod\n"
        "qs = load('quickstart_torch')\n"
        "out = qs.run_workload(qs.workload_specs()['text-to-text'], 2,\n"
        "                      reduced=True, device='cpu')\n"
        "assert out['live']['completed'] == 2\n"
        "sp = load('serve_pipeline_torch')\n"
        "out = sp.main(['--queries', '4', '--reduced', '--device', 'cpu'])\n"
        "assert out['auto']['completed'] == 4\n"
        "load('artifact_suite_torch')\n"
        "assert sys.modules['jax'] is None and sys.modules['repro'] is None\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_training_runs_with_jax_repro_and_msgpack_blocked(tmp_path):
    """``repro_torch.training``, the train launcher and the train_small twin
    on the CPU with jax, the JAX package and msgpack (the reference's
    checkpoint format, absent on the card's host) blocked."""
    code = (
        "import sys, importlib.util\n"
        "for name in ('jax', 'repro', 'msgpack'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.training\n"
        "from repro_torch.launch import train\n"
        f"ck = {str(tmp_path)!r}\n"
        "hist = train.main(['--steps', '2', '--seq', '8', '--global-batch',\n"
        "                   '2', '--device', 'cpu', '--ckpt-dir', ck + '/l'])\n"
        "assert len(hist) == 2\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    't', 'examples/train_small_torch.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "hist = mod.main(['--steps', '2', '--seq', '8', '--batch', '2',\n"
        "                 '--reduced', '--device', 'cpu',\n"
        "                 '--ckpt-dir', ck + '/s'])\n"
        "hist += mod.main(['--steps', '3', '--seq', '8', '--batch', '2',\n"
        "                  '--reduced', '--device', 'cpu', '--resume',\n"
        "                  '--ckpt-dir', ck + '/s'])\n"
        "assert len(hist) == 3\n"
        "import torch\n"
        "from repro_torch.kernels import ops\n"
        "g = torch.Generator().manual_seed(0)\n"
        "q, k, v = (torch.randn(1, 2, 5, 8, generator=g)\n"
        "           .requires_grad_(True) for _ in range(3))\n"
        "ig, fg = (torch.randn(1, 2, 5, generator=g) for _ in range(2))\n"
        "c, n = torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8)\n"
        "m = torch.full((1, 2), -1e30)\n"
        "h, _ = ops.mlstm_chunk(q, k, v, ig, fg, c, n, m)\n"
        "gq = torch.autograd.grad(h.sum(), q)[0]\n"
        "da = torch.rand(1, 5, 3, 4, generator=g).requires_grad_(True)\n"
        "gd = torch.autograd.grad(ops.ssm_scan(da, da.detach()).sum(),\n"
        "                         da)[0]\n"
        "assert torch.isfinite(gq).all() and gd.abs().sum() > 0\n"
        "assert all(sys.modules[n] is None for n in ('jax', 'repro',\n"
        "                                              'msgpack'))\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert (tmp_path / "l" / "step_00000002" / "params.pt").exists()


def test_anneal_and_launch_run_with_jax_and_repro_blocked():
    """``core/anneal_torch.py`` (a mode "torch" solve on the CPU) and every
    ``launch/`` module, the dry run on a fake group included, with jax and
    the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.core.anneal_torch\n"
        "import repro_torch.launch.roofline, repro_torch.launch.mesh\n"
        "import repro_torch.launch.sharding, repro_torch.launch.train\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.core.allocator import (MultiTenantAllocator,\n"
        "                                        SAConfig)\n"
        "from repro_torch.core.predictor import PipelinePredictor\n"
        "from repro_torch.core.types import RTX_2080TI, TenantSet\n"
        "from repro_torch.sim.workloads import multitenant_suite\n"
        "ts = TenantSet(multitenant_suite()['two-chains'])\n"
        "pred = PipelinePredictor.from_graph(ts.union_graph, RTX_2080TI,\n"
        "                                    seed=0)\n"
        "sa = SAConfig(iterations=100, seed=3, mode='torch', device='cpu')\n"
        "res = MultiTenantAllocator(ts, pred, RTX_2080TI, 4,\n"
        "                           sa=sa).solve_max_load(4)\n"
        "assert res.mode == 'torch' and res.feasible\n"
        "from repro_torch.configs.base import InputShape\n"
        "rec = dryrun.run_combo('qwen3-0.6b', 'x', mesh_shape=(2, 2),\n"
        "                       reduced=True,\n"
        "                       shp=InputShape('x', 16, 4, 'decode'))\n"
        "assert rec['status'] == 'ok' and rec['chips'] == 4\n"
        "assert sys.modules['jax'] is None and sys.modules['repro'] is None\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_train_launcher_refuses_the_production_mesh():
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--production-mesh", "--device", "cpu"])
