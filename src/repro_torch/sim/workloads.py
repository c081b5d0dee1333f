"""Camelot suite (paper §III): the four real 2-stage pipelines plus the
parametric artifact benchmark (compute-/memory-/PCIe-intensive stages) and
DAG-topology services beyond the paper's chain shape.

Real-system profiles are derived from the model zoo: per-query FLOPs come
from the architecture's analytic parameter counts (2·N_active per token ×
tokens per query), memory traffic from weight + activation reads, PCIe
traffic from the query payload.  Constants are sized so solo durations land
in the paper's regime (tens of ms per stage on a 2080Ti at mid batch).

``dag_suite`` adds non-chain call graphs (§"beyond the paper"): a diamond
ensemble (one extractor fanning out to two branches joined by a fusion
node) and a shared-backbone fan-out (one backbone feeding several task
heads, each an exit node).  They exercise the fan-in join barrier, the
multi-exit completion rule, and the critical-path Constraint-5.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.configs import active_param_count, get_config
from repro_torch.core.types import (RTX_2080TI, DeviceSpec,
                                    MicroserviceProfile, Pipeline,
                                    ServiceEdge, ServiceGraph, Tenant)


def _model_stage(name: str, arch: str, tokens_per_query: int,
                 payload_bytes: float, weights_scale: float = 1.0,
                 serial_frac: float = 0.08,
                 overhead: float = 2e-3) -> MicroserviceProfile:
    """Build a profile from a model-zoo architecture (reduced family parent).

    2 FLOPs/param/token forward; weight traffic once per batch; activation
    traffic ~4 bytes × d_model × tokens."""
    cfg = get_config(arch)
    n_active = active_param_count(cfg) * weights_scale
    flops_q = 2.0 * n_active * tokens_per_query
    # bf16 weights; traffic per query amortises weights over batch ~8
    weights_bytes = 2.0 * n_active
    act_bytes = 4.0 * cfg.d_model * tokens_per_query
    return MicroserviceProfile(
        name=name, arch=arch,
        flops_per_query=flops_q,
        mem_bytes_per_query=act_bytes * 6 + weights_bytes / 8,
        host_bytes_per_query=payload_bytes,
        weights_bytes=weights_bytes,
        act_bytes_per_query=act_bytes * 16,
        overhead=overhead,
        serial_frac=serial_frac)


def camelot_suite(device: DeviceSpec = RTX_2080TI) -> Dict[str, Pipeline]:
    """The four end-to-end services of Table I, mapped onto the model zoo.

    img-to-img : face recognition (vision backbone) -> image enhancement
    img-to-text: feature extraction (VLM backbone) -> caption decoder (LSTM-like)
    text-to-img: semantic understanding (LSTM-like) -> image generation
    text-to-text: summarisation (BERT-like) -> translation (enc-dec)
    """
    img_payload = 3 * 224 * 224 * 4.0          # one float32 image
    txt_payload = 512 * 4.0                    # token ids
    feat_payload = 4096 * 4.0                  # feature vector

    return {
        "img-to-img": Pipeline("img-to-img", [
            _model_stage("face-recognition", "qwen3-0.6b", 96, img_payload,
                         weights_scale=0.25, serial_frac=0.05),
            _model_stage("image-enhancement", "qwen1.5-0.5b", 48, img_payload,
                         weights_scale=0.15, serial_frac=0.12),
        ], qos_target=0.20),
        "img-to-text": Pipeline("img-to-text", [
            _model_stage("feature-extraction", "qwen1.5-0.5b", 96,
                         img_payload, weights_scale=0.4, serial_frac=0.05),
            _model_stage("image-caption", "xlstm-1.3b", 24, feat_payload,
                         weights_scale=0.10, serial_frac=0.18),
        ], qos_target=0.25),
        "text-to-img": Pipeline("text-to-img", [
            _model_stage("semantic-understanding", "xlstm-1.3b", 32,
                         txt_payload, weights_scale=0.08, serial_frac=0.15),
            _model_stage("image-generation", "qwen1.5-0.5b", 128, img_payload,
                         weights_scale=0.35, serial_frac=0.04),
        ], qos_target=0.30),
        "text-to-text": Pipeline("text-to-text", [
            _model_stage("text-summarization", "qwen3-0.6b", 96, txt_payload,
                         weights_scale=0.35, serial_frac=0.06),
            _model_stage("text-translation", "whisper-medium", 64,
                         txt_payload, weights_scale=0.3, serial_frac=0.10),
        ], qos_target=0.25),
    }


# --------------------------------------------------------------------------
# DAG services (beyond the paper's chains)
# --------------------------------------------------------------------------

def diamond_service(device: DeviceSpec = RTX_2080TI,
                    qos_target: float = 0.30) -> ServiceGraph:
    """Ensemble diamond: extract -> {caption, classify} -> fuse.

    One feature extractor fans its embedding out to two independent
    branches; a light fusion node joins them (the fan-in barrier releases a
    batch only when both branch outputs arrived).  Edge payloads: the fat
    feature vector goes to both branches, each branch returns a small
    result to the fusion node."""
    feat_payload = 4096 * 4.0
    result_payload = 256 * 4.0
    nodes = [
        _model_stage("extract", "qwen1.5-0.5b", 96, 3 * 224 * 224 * 4.0,
                     weights_scale=0.4, serial_frac=0.05),
        _model_stage("caption", "xlstm-1.3b", 24, feat_payload,
                     weights_scale=0.10, serial_frac=0.18),
        _model_stage("classify", "qwen3-0.6b", 16, feat_payload,
                     weights_scale=0.15, serial_frac=0.08),
        _model_stage("fuse", "qwen1.5-0.5b", 8, result_payload,
                     weights_scale=0.05, serial_frac=0.10, overhead=1e-3),
    ]
    edges = [
        ServiceEdge(0, 1, payload_bytes_per_query=feat_payload),
        ServiceEdge(0, 2, payload_bytes_per_query=feat_payload),
        ServiceEdge(1, 3, payload_bytes_per_query=result_payload),
        ServiceEdge(2, 3, payload_bytes_per_query=result_payload),
    ]
    return ServiceGraph("diamond", nodes, edges, qos_target=qos_target)


def shared_backbone_service(n_heads: int = 3,
                            device: DeviceSpec = RTX_2080TI,
                            qos_target: float = 0.30) -> ServiceGraph:
    """Shared feature backbone fanning out to ``n_heads`` task heads.

    Every head is an exit node: a query completes only once ALL heads have
    produced their output (the multi-exit completion rule), so the service
    latency is the backbone plus the slowest head."""
    feat_payload = 4096 * 4.0
    nodes = [_model_stage("backbone", "qwen1.5-0.5b", 96,
                          3 * 224 * 224 * 4.0, weights_scale=0.4,
                          serial_frac=0.05)]
    edges = []
    head_archs = ["qwen3-0.6b", "xlstm-1.3b", "qwen1.5-0.5b"]
    for h in range(n_heads):
        nodes.append(_model_stage(
            f"head-{h}", head_archs[h % len(head_archs)], 16 + 8 * h,
            feat_payload, weights_scale=0.08, serial_frac=0.10))
        edges.append(ServiceEdge(0, 1 + h,
                                 payload_bytes_per_query=feat_payload))
    return ServiceGraph(f"backbone-{n_heads}h", nodes, edges,
                        qos_target=qos_target)


def ensemble_service(n_branches: int = 3,
                     device: DeviceSpec = RTX_2080TI,
                     qos_target: float = 0.45) -> ServiceGraph:
    """Six-node ensemble: extract -> {3 branches} -> fuse -> render.

    The deepest DAG in the suite (path length 4, plus a 3-way fan-in): the
    policy-hot-path benchmark uses it as the stress case for the allocator
    — 6 nodes means a 12-dimensional decision vector and 7 edges on the
    critical-path evaluation."""
    feat_payload = 4096 * 4.0
    result_payload = 256 * 4.0
    nodes = [
        _model_stage("extract", "qwen1.5-0.5b", 96, 3 * 224 * 224 * 4.0,
                     weights_scale=0.4, serial_frac=0.05),
    ]
    edges = []
    branch_archs = ["qwen3-0.6b", "xlstm-1.3b", "qwen1.5-0.5b"]
    for b in range(n_branches):
        nodes.append(_model_stage(
            f"branch-{b}", branch_archs[b % len(branch_archs)], 16 + 8 * b,
            feat_payload, weights_scale=0.08, serial_frac=0.10))
        edges.append(ServiceEdge(0, 1 + b,
                                 payload_bytes_per_query=feat_payload))
    fuse = len(nodes)
    nodes.append(_model_stage("fuse", "qwen1.5-0.5b", 8, result_payload,
                              weights_scale=0.05, serial_frac=0.10,
                              overhead=1e-3))
    for b in range(n_branches):
        edges.append(ServiceEdge(1 + b, fuse,
                                 payload_bytes_per_query=result_payload))
    nodes.append(_model_stage("render", "qwen1.5-0.5b", 32, result_payload,
                              weights_scale=0.1, serial_frac=0.08))
    edges.append(ServiceEdge(fuse, fuse + 1,
                             payload_bytes_per_query=result_payload))
    return ServiceGraph(f"ensemble-{len(nodes)}", nodes, edges,
                        qos_target=qos_target)


def dag_suite(device: DeviceSpec = RTX_2080TI) -> Dict[str, ServiceGraph]:
    """Non-chain services charged through the same allocator → packer →
    simulator/engine path as the paper's pipelines."""
    return {
        "diamond": diamond_service(device),
        "backbone-3h": shared_backbone_service(3, device),
        "ensemble-6": ensemble_service(3, device),
    }


def multitenant_suite(device: DeviceSpec = RTX_2080TI,
                      ) -> Dict[str, List[Tenant]]:
    """Multi-tenant co-location scenarios: SETS of services sharing one
    device pool (the datacenter consolidation case).  Each scenario is a
    tenant list for ``TenantSet``/``MultiServiceSession``; every tenant
    keeps its own QoS target, and the joint allocator packs them against
    shared per-device quota/bandwidth/memory.

      chain+diamond  — a paper chain co-located with the DAG ensemble
                       (the asymmetric pair: fractional device shares beat
                       any whole-device static split)
      two-chains     — two of the paper's Table-I services side by side
      3-tenant-mixed — two chains plus the multi-exit backbone fan-out
    """
    chains = camelot_suite(device)
    dags = dag_suite(device)
    return {
        "chain+diamond": [
            Tenant("img-to-img", chains["img-to-img"]),
            Tenant("diamond", dags["diamond"]),
        ],
        "two-chains": [
            Tenant("img-to-text", chains["img-to-text"]),
            Tenant("text-to-text", chains["text-to-text"]),
        ],
        "3-tenant-mixed": [
            Tenant("img-to-img", chains["img-to-img"]),
            Tenant("text-to-img", chains["text-to-img"]),
            Tenant("backbone-3h", dags["backbone-3h"]),
        ],
    }


def synthetic_tenant_set(n_tenants: int, device: DeviceSpec = RTX_2080TI,
                         seed: int = 0) -> "TenantSet":
    """A datacenter-scale tenant population for solver-scaling benchmarks.

    Tenants are drawn from the suite templates (the four Table-I chains
    plus the DAG services) with a jittered per-tenant QoS target and a
    **diurnal load mix** for the weights: tenant phases are spread around
    the clock, so at the snapshot the solver sees the usual datacenter
    blend of peak tenants (weight ~1) and off-peak tenants (weight ~0.25)
    — the weighted max-min objective then has real imbalance to exploit.
    Node profiles are SHARED with the templates (``MicroserviceProfile``
    is frozen), so ``synthetic_predictor`` fits one model per distinct
    profile instead of one per tenant."""
    from repro_torch.core.types import TenantSet
    rng = np.random.default_rng(seed)
    templates = {**camelot_suite(device), **dag_suite(device)}
    names = sorted(templates)
    tenants = []
    for i in range(n_tenants):
        tmpl = templates[names[int(rng.integers(len(names)))]]
        qos = float(tmpl.qos_target * rng.uniform(0.9, 1.4))
        graph = ServiceGraph(f"{tmpl.name}-{i:03d}", tmpl.nodes,
                             tmpl.edges, qos_target=qos)
        phase = rng.uniform(0.0, 1.0)
        weight = 0.25 + 0.75 * 0.5 * (1.0 + np.sin(2 * np.pi * phase))
        tenants.append(Tenant(graph.name, graph, weight=round(weight, 3)))
    return TenantSet(tenants)


def synthetic_predictor(tenants, device: DeviceSpec = RTX_2080TI,
                        seed: int = 0):
    """Per-node predictors for a (synthetic) TenantSet with one fit per
    DISTINCT profile: the generator reuses the template stages across
    tenants, so a 256-tenant population needs ~a dozen model fits instead
    of ~900.  Returns a ``PipelinePredictor`` over the union node order."""
    from repro_torch.core.predictor import (PipelinePredictor, collect_samples,
                                            TabulatedStagePredictor)
    fitted: Dict = {}
    stages = []
    for i, prof in enumerate(tenants.union_graph.nodes):
        sp = fitted.get(prof)
        if sp is None:
            samples = collect_samples(prof, device,
                                      seed=seed + len(fitted))
            sp = TabulatedStagePredictor(
                prof.name, "dt", seed=seed + len(fitted)).fit(
                    samples, profile=prof)
            fitted[prof] = sp
        stages.append(sp)
    return PipelinePredictor(stages)


# --------------------------------------------------------------------------
# Tenant churn (lifecycle control plane scenarios)
# --------------------------------------------------------------------------

def churn_suite(device: DeviceSpec = RTX_2080TI) -> List[Tenant]:
    """Deterministic incumbents for lifecycle scenarios: three artifact
    chains with tiered priorities, one of them isolated (a quota floor) —
    the starting population every churn trace mutates."""
    def chain(name, kinds, qos, **kw):
        return Tenant(name, Pipeline(
            name, [artifact_stage(k, l, device) for k, l in kinds],
            qos_target=qos), **kw)
    return [
        chain("base-lo", [("p", 1), ("c", 1)], 0.25, weight=1.0,
              required_load=40.0, priority=0),
        chain("base-mid", [("c", 2), ("m", 1)], 0.30, weight=1.0,
              required_load=30.0, priority=1),
        chain("base-hi", [("p", 2), ("m", 2)], 0.35, weight=1.5,
              required_load=30.0, priority=2, quota_floor=0.5),
    ]


def churn_tenant(i: int, rng: np.random.Generator,
                 device: DeviceSpec = RTX_2080TI) -> Tenant:
    """One seeded arrival: a 2-stage artifact chain with jittered QoS,
    demand, priority tier and (sometimes) an isolation floor or cap.
    Artifact stages are drawn from the fixed 9-profile pool, so churned
    populations share profiles and predictor fits are reused."""
    kinds = ("c", "m", "p")
    s1 = artifact_stage(kinds[int(rng.integers(3))],
                        int(rng.integers(1, 4)), device)
    s2 = artifact_stage(kinds[int(rng.integers(3))],
                        int(rng.integers(1, 4)), device)
    name = f"churn-{i:03d}"
    graph = Pipeline(name, [s1, s2],
                     qos_target=float(rng.uniform(0.2, 0.4)))
    floor = 0.0
    cap = None
    style = rng.uniform()
    if style < 0.2:
        floor = float(rng.choice([0.25, 0.5]))
    elif style < 0.35:
        cap = float(rng.choice([1.0, 1.5, 2.0]))
    return Tenant(name, graph,
                  weight=float(np.round(rng.uniform(0.5, 1.5), 3)),
                  required_load=float(np.round(rng.uniform(15.0, 60.0), 1)),
                  priority=int(rng.integers(0, 3)),
                  quota_floor=floor, quota_cap=cap)


def churn_trace(n_events: int = 12, seed: int = 0,
                device: DeviceSpec = RTX_2080TI,
                arrival_frac: float = 0.5) -> List[Dict]:
    """A seeded tenant-churn script for the lifecycle control plane.

    Returns a list of event dicts, one per control interval ``t = k``:

      {"t", "op": "admit",  "tenant": Tenant}        — arrival
      {"t", "op": "remove", "name": str}             — departure
      {"t", "op": "scale",  "name": str, "factor": float}
      {"t", "op": "spike",  "factor": float}         — pool-wide load
                                                       spike (preemption)

    ``remove``/``scale`` only name tenants the trace itself admitted (the
    ``churn_suite`` incumbents persist), so any replayer that starts from
    the suite can apply the script verbatim.  Same seed => same script."""
    rng = np.random.default_rng(seed)
    events: List[Dict] = []
    admitted: List[str] = []
    next_id = 0
    for k in range(n_events):
        r = float(rng.uniform())
        if r < arrival_frac or not admitted:
            tenant = churn_tenant(next_id, rng, device)
            next_id += 1
            admitted.append(tenant.name)
            events.append({"t": float(k), "op": "admit", "tenant": tenant})
        elif r < arrival_frac + 0.2:
            name = admitted.pop(int(rng.integers(len(admitted))))
            events.append({"t": float(k), "op": "remove", "name": name})
        elif r < arrival_frac + 0.35:
            name = admitted[int(rng.integers(len(admitted)))]
            events.append({"t": float(k), "op": "scale", "name": name,
                           "factor": float(np.round(
                               rng.uniform(0.6, 1.6), 3))})
        else:
            events.append({"t": float(k), "op": "spike",
                           "factor": float(np.round(
                               rng.uniform(2.0, 4.0), 3))})
    return events


# --------------------------------------------------------------------------
# Artifact benchmark (§III-B): parametric c/m/p-intensive stages
# --------------------------------------------------------------------------

_INTENSITY = (1.0, 2.0, 4.0)


def artifact_stage(kind: str, level: int,
                   device: DeviceSpec = RTX_2080TI) -> MicroserviceProfile:
    """kind in {"c","m","p"}, level in {1,2,3}; higher level = more intense
    (paper: c3 more compute-intensive than c2 > c1, etc.)."""
    assert kind in ("c", "m", "p") and level in (1, 2, 3)
    mult = _INTENSITY[level - 1]
    base_flops = 10e9            # ~0.75 ms/query at full quota on 2080Ti
    base_mem = 40e6
    base_host = 0.5e6
    if kind == "c":
        f, m, h, sf = base_flops * mult, base_mem, base_host, 0.04
    elif kind == "m":
        f, m, h, sf = base_flops * 0.15, 360e6 * mult, base_host, 0.10
    else:
        f, m, h, sf = base_flops * 0.15, base_mem, 2e6 * mult, 0.08
    return MicroserviceProfile(
        name=f"{kind}{level}",
        flops_per_query=f,
        mem_bytes_per_query=m,
        host_bytes_per_query=h,
        weights_bytes=500e6,
        act_bytes_per_query=24e6 * (mult if kind == "m" else 1.0),
        overhead=1e-3,
        serial_frac=sf)


def artifact_pipelines(device: DeviceSpec = RTX_2080TI) -> Dict[str, Pipeline]:
    """The 3×3×3 = 27 pipelines p_i + c_j + m_k of §VIII-E."""
    out = {}
    for pi in (1, 2, 3):
        for ci in (1, 2, 3):
            for mi in (1, 2, 3):
                name = f"p{pi}+c{ci}+m{mi}"
                out[name] = Pipeline(name, [
                    artifact_stage("p", pi, device),
                    artifact_stage("c", ci, device),
                    artifact_stage("m", mi, device),
                ], qos_target=0.25)
    return out


def workload_specs(device: DeviceSpec = RTX_2080TI,
                   include_artifacts: bool = False) -> Dict:
    """Every suite workload as declarative data: the chain suite plus the
    DAG suite (and optionally the 27 artifact pipelines) lifted to
    ``repro_torch.camelot.ServiceSpec`` — the facade's spec-driven entry
    point for examples and benchmarks."""
    # function-level import: repro_torch.camelot sits ABOVE this module
    # (its session imports repro_torch.sim), so a module-level import
    # would cycle
    from repro_torch.camelot.specs import ServiceSpec
    graphs: Dict[str, ServiceGraph] = {**camelot_suite(device),
                                       **dag_suite(device)}
    if include_artifacts:
        graphs.update(artifact_pipelines(device))
    return {name: ServiceSpec.from_graph(g) for name, g in graphs.items()}
