"""PyTorch / CUDA port of the FFTrainer reproduction, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``models``, ``kernels``, ``train``, ``launch``) and imports
nothing of it. Slice 1 serves the dense decoder (prefill + greedy KV-cache
decode) with two hand-written CUDA kernels:

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    model = build_model(get_arch("qwen3-0.6b"))          # on CUDA

Slice 5 trains the dense decoder with failover through the port's
simulated cluster; the public names of ``repro`` ported so far are exported
here, lazily (``Scenario`` and ``run_scenario`` are not ported yet):

    from repro_torch import SimCluster, ClusterConfig, FaultScript
    clu = SimCluster(get_arch("qwen3-0.6b"), ClusterConfig(seq_len=1024))
    clu.run(2); clu.inject_failure([2]); clu.recover(); clu.run(2)

Importing this package builds nothing: the kernels are compiled with
``nvcc`` at their first launch (``repro_torch.kernels._build``), and
touching ``repro_torch.SimCluster`` is what imports the runtime.
"""
from __future__ import annotations

__all__ = [
    "SimCluster",
    "ClusterConfig",
    "FabricConfig",
    "FaultScript",
    "RecoveryPolicy",
    "RecoveryPlan",
    "RecoveryReport",
    "RecoveryError",
    "RoutingError",
    "StreamRecovery",
    "ComputeRecovery",
    "HybridRecovery",
    "fftrainer_timeline",
    "baseline_timeline",
    "compute_recovery_timeline",
    "PodFabric",
    "TrafficPlan",
    "compile_traffic_plan",
    "ReliabilityConfig",
]

_EXPORTS = {
    "SimCluster": "repro_torch.runtime.cluster",
    "ClusterConfig": "repro_torch.runtime.cluster",
    "FabricConfig": "repro_torch.runtime.cluster",
    "FaultScript": "repro_torch.runtime.recovery",
    "RecoveryPolicy": "repro_torch.runtime.recovery",
    "RecoveryPlan": "repro_torch.runtime.recovery",
    "RecoveryReport": "repro_torch.runtime.recovery",
    "RecoveryError": "repro_torch.runtime.recovery",
    "RoutingError": "repro_torch.core.lccl",
    "StreamRecovery": "repro_torch.runtime.recovery",
    "ComputeRecovery": "repro_torch.runtime.recovery",
    "HybridRecovery": "repro_torch.runtime.recovery",
    "fftrainer_timeline": "repro_torch.runtime.failover",
    "baseline_timeline": "repro_torch.runtime.failover",
    "compute_recovery_timeline": "repro_torch.runtime.failover",
    "PodFabric": "repro_torch.core.lccl",
    "TrafficPlan": "repro_torch.core.plan",
    "compile_traffic_plan": "repro_torch.core.plan",
    "ReliabilityConfig": "repro_torch.runtime.reliability",
}


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value            # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
