"""The port's live serving engine on the CPU: the contracts of
tests/test_serving.py, and parity with the reference's engine."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import Allocation as RefAllocation
from repro.core.types import Placement as RefPlacement
from repro.core.types import StageAlloc as RefStageAlloc
from repro.serving import ModelStageServer as RefStageServer
from repro.serving import PipelineEngine as RefPipelineEngine
from repro.serving import make_trace as ref_make_trace
from repro_torch.core import HOST_STAGED, EdgeChannel
from repro_torch.core.types import Allocation, Placement, StageAlloc
from repro_torch.serving import (ModelStageServer, MultiTenantEngine,
                                 PipelineEngine, make_trace)

ARCHS = ("qwen3-0.6b", "qwen1.5-0.5b")


@pytest.fixture(scope="module")
def stages():
    return [ModelStageServer("s0", ARCHS[0], seq_len=16, reduced=True,
                             device="cpu"),
            ModelStageServer("s1", ARCHS[1], seq_len=16, reduced=True,
                             device="cpu")]


def _fresh_trace(stages, n=10, qps=50):
    return make_trace(n, qps=qps, seq_len=16,
                      vocab=stages[0].cfg.vocab_size, seed=1)


def _two_instance_alloc(mod_alloc=Allocation, mod_stage=StageAlloc,
                        mod_place=Placement):
    return mod_alloc(
        stages=[mod_stage(2, 0.25, 4), mod_stage(1, 0.5, 4)],
        placement=mod_place(per_stage=[[(0, 0.25), (0, 0.25)], [(0, 0.5)]]))


def test_engine_completes_all_queries(stages):
    eng = PipelineEngine(stages, comm_mechanism="device", qos_target=2.0,
                         batch_size=4, batch_timeout=0.02)
    s = eng.run_trace(_fresh_trace(stages)).summary()
    assert s["completed"] == 10
    assert s["failed"] == 0
    assert s["p99"] > 0


def test_host_mechanism_moves_bytes(stages):
    eng = PipelineEngine(stages, comm_mechanism="host", qos_target=2.0,
                         batch_size=4, batch_timeout=0.02)
    stats = eng.run_trace(_fresh_trace(stages))
    assert stats.comm_time > 0
    assert eng.channels[0].bytes_moved > 0


def test_device_mechanism_zero_copy(stages):
    eng = PipelineEngine(stages, comm_mechanism="device", qos_target=2.0,
                         batch_size=4, batch_timeout=0.02)
    eng.run_trace(_fresh_trace(stages))
    assert eng.channels[0].transfers > 0
    assert eng.channels[0].bytes_moved == 0
    out = torch.arange(4, dtype=torch.int32)
    assert EdgeChannel(force="device").send(out) is out   # by reference
    staged = EdgeChannel(force="host").send(out)
    assert staged is not out and torch.equal(staged, out)


def test_edge_payload_is_int32_ids(stages):
    """The stage output is (B,) int32, as the reference's, so each edge is
    sized and routed alike."""
    out = stages[0].process(torch.zeros(4, 16, dtype=torch.int32))
    assert out.dtype == torch.int32 and out.shape == (4,)


def test_engine_consumes_allocation_with_placement(stages):
    eng = PipelineEngine(stages, allocation=_two_instance_alloc(),
                         comm_mechanism="auto", qos_target=2.0,
                         batch_timeout=0.02)
    stats = eng.run_trace(_fresh_trace(stages))
    assert stats.summary()["completed"] == 10
    # the (B,) int32 payload sits below the Fig. 11 crossover: host-staged
    assert eng.channels[0].picks[HOST_STAGED] > 0


def test_processes_backend_not_ported(stages):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PipelineEngine(stages, backend="processes")
    with pytest.raises(NotImplementedError, match="CUDA IPC"):
        MultiTenantEngine([stages], [None], [None], backend="processes")


def _fp32_pair(arch, seed=0):
    """The reference's stage server with its parameters cast to fp32, and
    the port's server holding the same parameters."""
    ref = RefStageServer(f"ref-{arch}", arch, seq_len=16, seed=seed)
    ref.params = jax.tree.map(lambda x: x.astype(jnp.float32), ref.params)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), ref.params)
    port = ModelStageServer(f"port-{arch}", arch, seq_len=16, seed=seed,
                            reduced=True, device="cpu", dtype=torch.float32,
                            params=tree)
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_output_ids_match_reference(arch):
    ref, port = _fp32_pair(arch)
    toks = np.random.default_rng(0).integers(
        0, ref.cfg.vocab_size, (4, 16)).astype(np.int32)
    ids_ref = np.asarray(ref.process(jnp.asarray(toks)))
    ids = port.process(torch.from_numpy(toks))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), ids_ref)


@pytest.mark.parametrize("mech", ["auto", "device"])
def test_engine_matches_reference_engine(mech):
    """The same trace through both engines: equal completions and equal
    per-edge mechanism picks (queries arrive at once and batches fill, so
    batching is deterministic)."""
    (r0, p0), (r1, p1) = _fp32_pair(ARCHS[0]), _fp32_pair(ARCHS[1], seed=1)
    kw = dict(comm_mechanism=mech, qos_target=2.0, batch_timeout=0.5)
    ref_eng = RefPipelineEngine(
        [r0, r1], allocation=_two_instance_alloc(
            RefAllocation, RefStageAlloc, RefPlacement), **kw)
    eng = PipelineEngine([p0, p1], allocation=_two_instance_alloc(), **kw)
    args = dict(n=12, qps=1e6, seq_len=16, vocab=r0.cfg.vocab_size, seed=3)
    s_ref = ref_eng.run_trace(ref_make_trace(**args)).summary()
    s = eng.run_trace(make_trace(**args)).summary()
    assert s["completed"] == s_ref["completed"] == 12
    assert eng.channels[0].picks == ref_eng.channels[0].picks


class _RaisingStage:
    """Wraps a stage server; its ``process`` always raises."""

    def __init__(self, inner):
        self.inner = inner
        self.name, self.seq_len, self.cfg = inner.name, inner.seq_len, \
            inner.cfg
        self.device = getattr(inner, "device", None)

    def warmup(self, batch):
        pass

    def process(self, tokens):
        raise RuntimeError("stage down")


@pytest.mark.parametrize("bad", [0, 1])
def test_raising_stage_fails_its_queries_like_reference(bad):
    """A stage that raises loses its batches: every query is counted
    failed, none completes and the trace still ends, in both engines."""
    (r0, p0), (r1, p1) = _fp32_pair(ARCHS[0]), _fp32_pair(ARCHS[1], seed=1)
    ref_stages, stages = [r0, r1], [p0, p1]
    ref_stages[bad] = _RaisingStage(ref_stages[bad])
    stages[bad] = _RaisingStage(stages[bad])
    kw = dict(comm_mechanism="auto", qos_target=2.0, batch_size=4,
              batch_timeout=0.02)
    args = dict(n=8, qps=1e6, seq_len=16, vocab=r0.cfg.vocab_size, seed=5)
    s_ref = RefPipelineEngine(ref_stages, **kw).run_trace(
        ref_make_trace(**args)).summary()
    s = PipelineEngine(stages, **kw).run_trace(make_trace(**args)).summary()
    assert s["failed"] == s_ref["failed"] == 8
    assert s["completed"] == s_ref["completed"] == 0


def test_stage_server_pickles_to_an_equal_replica(stages):
    import pickle
    replica = pickle.loads(pickle.dumps(stages[0]))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, stages[0].cfg.vocab_size, (2, 16)).astype(np.int32))
    assert torch.equal(replica.process(toks), stages[0].process(toks))
    assert dataclasses.asdict(replica.cfg) == dataclasses.asdict(
        stages[0].cfg)
