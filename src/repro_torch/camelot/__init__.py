# repro_torch.camelot — the declarative control plane over the Camelot
# runtime, the port's copy of the reference's facade.
#
# The public front door: describe WHAT/WHERE/HOW-WELL
# with frozen specs (ServiceSpec / ClusterSpec / QoSSpec, dict
# round-trippable), drive the whole lifecycle through one CamelotSession
# (profile -> solve -> simulate -> serve -> reallocate), and pick solvers
# from the pluggable policy registry (max-peak, min-resource, even,
# standalone, laius, camelot-nc — register_policy adds more).
#
#   specs.py    — ServiceSpec / ClusterSpec / QoSSpec / LoadSpec
#   policies.py — Policy protocol, registry, built-in policies
#   session.py  — CamelotSession facade
#
# The internal layers (repro_torch.core.*, repro_torch.sim.*,
# repro_torch.serving.*) remain importable and unchanged; the facade only
# wires them.
from repro_torch.camelot.specs import (KNOWN_DEVICES, ClusterSpec, LoadSpec,
                                       MultiServiceSpec, QoSSpec, ServeSpec,
                                       ServiceSpec, SolverSpec, TenantSpec)
from repro_torch.camelot.policies import (BaselinePolicy, MaxPeakPolicy,
                                          MinResourcePolicy, Policy,
                                          UnknownPolicyError,
                                          available_policies, get_policy,
                                          register_policy)
from repro_torch.camelot.session import CamelotSession, MultiServiceSession
from repro_torch.core.allocator import SAConfig, SolveResult
from repro_torch.core.lifecycle import (AdmissionDecision, AdmissionQuote,
                                        LifecycleEvent, LifecycleManager)

__all__ = [
    "KNOWN_DEVICES", "ClusterSpec", "LoadSpec", "MultiServiceSpec",
    "QoSSpec", "ServeSpec", "ServiceSpec", "SolverSpec", "TenantSpec",
    "BaselinePolicy",
    "MaxPeakPolicy", "MinResourcePolicy", "Policy", "UnknownPolicyError",
    "available_policies", "get_policy", "register_policy", "CamelotSession",
    "MultiServiceSession", "SAConfig", "SolveResult",
    "AdmissionDecision", "AdmissionQuote", "LifecycleEvent",
    "LifecycleManager",
]
