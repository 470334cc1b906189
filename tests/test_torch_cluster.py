"""The port's SimCluster against the JAX package's, and its failover
within the port, at the smoke size of qwen3-0.6b in fp32 on the CPU: loss
tracking from the same initial state, bitwise recovery from the neighbour,
hardware failure, the full-checkpoint fallback, the modeled recovery
reports, and full checkpoints that cross between the packages."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.storage import load_pytree as j_load_pytree
from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime.cluster import ClusterConfig as JClusterConfig
from repro.runtime.cluster import FabricConfig as JFabricConfig
from repro.runtime.cluster import SimCluster as JSimCluster
from repro.runtime.recovery import _flatten_opt as j_flatten_opt
from repro_torch import tree
from repro_torch.ckpt.storage import load_pytree
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.optim import AdamWConfig
from repro_torch.roofline import hw
from repro_torch.runtime.cluster import (ClusterConfig, FabricConfig, FaultScript,
                                         SimCluster)
from repro_torch.runtime.recovery import _flatten_opt

ROOT = Path(__file__).resolve().parent.parent
# the parity runs pass the reference's fabric to both packages explicitly:
# the port's defaults are an H100 cluster's (roofline/hw.py)
FABRIC = dict(link_bw=50e9, dcn_bw=5e9)
HP = dict(lr=1e-3, warmup_steps=2, total_steps=50)
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)


def _cluster_kw(tmp_path, dp, full_every, seed):
    return dict(dp=dp, global_batch=8, seq_len=16, ckpt_dir=tmp_path / "ck",
                full_every=full_every, seed=seed)


def _mk(tmp_path, dp=4, full_every=50, seed=0, fabric=None, recovery=None, clock=None):
    """The port's cluster as tests/test_failover_integration.py builds the
    reference's (smoke qwen3-0.6b, fp32: bitwise-stable)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32")
    return SimCluster(cfg, cluster=ClusterConfig(hp=AdamWConfig(**HP),
                                                 **_cluster_kw(tmp_path, dp, full_every, seed)),
                      fabric=FabricConfig(**(fabric or {})), recovery=recovery, device="cpu",
                      clock=clock)


def _mk_jax(tmp_path, fabric, dp=4, full_every=50, seed=0, recovery=None):
    cfg = dataclasses.replace(j_reduce(j_get_arch("qwen3-0.6b")), dtype="float32")
    return JSimCluster(cfg, cluster=JClusterConfig(hp=JAdamWConfig(**HP),
                                                   **_cluster_kw(tmp_path, dp, full_every, seed)),
                       fabric=JFabricConfig(**fabric), recovery=recovery)


def _pair(tmp_path, fabric=None, **kw):
    """A JAX cluster and a port cluster started from the JAX one's state."""
    fabric = {**FABRIC, **(fabric or {})}
    j = _mk_jax(tmp_path / "jax", fabric=fabric, **kw)
    t = _mk(tmp_path / "port", fabric=fabric, **kw)
    t.load_state(jax.tree.map(np.asarray, j.state))
    return j, t


def _state_equal(a, b):
    la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(tree.to_numpy(x), tree.to_numpy(y)) for x, y in zip(la, lb))


def test_five_steps_track_jax(tmp_path):
    j, t = _pair(tmp_path)
    np.testing.assert_array_equal(_flatten_opt(t.state["opt"])[0],
                                  j_flatten_opt(j.state["opt"])[0])
    jl, tl = j.run(5), t.run(5)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    np.testing.assert_allclose(_flatten_opt(t.state["opt"])[0],
                               j_flatten_opt(j.state["opt"])[0], **LOSS_TOL)
    assert t.iteration == j.iteration == 5 and int(t.state["step"]) == 5
    assert t.instant_hidden == j.instant_hidden and t.sim_time == j.sim_time


# ---- the port's versions of tests/test_failover_integration.py:32-73 ---- #
def test_software_failure_bitwise_recovery(tmp_path):
    ref = _mk(tmp_path / "a")
    ref.run(10)

    clu = _mk(tmp_path / "b")
    clu.run(5)
    clu.inject_failure([2])
    rep = clu.recover()
    assert rep.recovered_from == "neighbor"
    assert rep.rolled_back_iterations == 0      # instant ckpt: no rollback
    clu.run(10 - clu.iteration)
    assert clu.iteration == 10
    assert _state_equal(ref.state, clu.state)
    assert ref.loss_history[-1] == clu.loss_history[-1]


def test_hardware_failure_recovery(tmp_path):
    ref = _mk(tmp_path / "a")
    ref.run(8)

    clu = _mk(tmp_path / "b")
    clu.run(4)
    clu.inject_failure([1], hardware=True)      # host RAM lost too
    rep = clu.recover(FaultScript(hardware=True))
    assert rep.recovered_from == "neighbor"     # worker 2 held the backup
    clu.run(8 - clu.iteration)
    assert _state_equal(ref.state, clu.state)


def test_adjacent_failure_falls_back_to_full_ckpt(tmp_path):
    """Worker and its DP-ring successor both fail -> neighbor copy is gone
    -> multi-level insurance (full CKPT) + rollback."""
    clu = _mk(tmp_path / "c", full_every=3)
    clu.run(7)                                  # full ckpts at it 3 and 6
    clu.inject_failure([1, 2], hardware=True)   # 2 held 1's backup
    rep = clu.recover(FaultScript(hardware=True))
    assert rep.recovered_from == "full_ckpt"
    assert rep.resume_iteration == 6
    assert rep.rolled_back_iterations == 1      # 7 -> 6
    assert int(clu.state["step"]) == 6
    clu.run(3)
    assert clu.iteration == 9
    assert np.isfinite(clu.loss_history[-1])


# the storm fabric of tests/test_recovery_policy.py: two pods, a slow DCN
STORM_FABRIC = dict(quantum=2048, pods=2, dcn_bw=2e5, dcn_latency=1e-4)
# (policy, steps before the failure, failed workers or "storm", hardware,
# full_every, fabric)
FAULTS = {"software": ("stream", 5, [2], False, 50, None),
          "hardware": ("stream", 4, [1], True, 50, None),
          "adjacent": ("stream", 7, [1, 2], True, 3, None),
          "compute_adjacent": ("compute", 4, [1, 2], True, 3, None),
          "hybrid_storm": ("hybrid", 2, "storm", False, 50, STORM_FABRIC)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_recovery_report_equals_jax(tmp_path, fault):
    """For the same cluster, state, policy and fault, the port's
    RecoveryReport (modeled timeline, chunks, bytes on the simulated fabric,
    replay compute) is the reference's, field for field, and the state
    after recovery tracks it."""
    policy, steps, failed, hardware, full_every, fabric = FAULTS[fault]
    j, t = _pair(tmp_path, full_every=full_every, fabric=fabric, recovery=policy)
    reports = []
    for clu in (j, t):
        clu.run(steps)
        if failed == "storm":
            clu.inject_storm(7, pods=1)        # darkens pod 1 (workers 2, 3)
        else:
            clu.inject_failure(failed, hardware=hardware)
        reports.append(clu.recover(FaultScript(hardware=hardware)))
    assert dataclasses.asdict(reports[1]) == dataclasses.asdict(reports[0])
    assert t.iteration == j.iteration and t.sim_time == j.sim_time
    np.testing.assert_allclose(_flatten_opt(t.state["opt"])[0],
                               j_flatten_opt(j.state["opt"])[0], **LOSS_TOL)


# ---- the port's versions of tests/test_recovery_policy.py:165-212 ---- #
def test_compute_recovery_zero_state_traffic_bitwise(tmp_path):
    ref = _mk(tmp_path / "ref")
    ref.run(7)
    clu = _mk(tmp_path / "comp", recovery="compute")
    clu.run(4)
    clu.inject_failure([1])
    before = clu.transport.accounting()["state_bytes"]
    rep = clu.recover()
    assert rep.state_bytes_streamed == 0.0 and rep.policy == "compute"
    assert rep.recovered_from == "compute_replay" and rep.rolled_back_iterations == 0
    # the lazy backup of the params is the only STATE traffic of recover()
    lazy = sum(int(np.prod(l.shape)) * 4 for l in tree.tree_leaves(clu.state["params"]))
    assert clu.transport.accounting()["state_bytes"] - before == lazy
    clu.run(3)
    assert _state_equal(clu.state, ref.state)  # rebuilt CURRENT state, not a rollback


def test_compute_survives_adjacent_double_hardware(tmp_path):
    ref = _mk(tmp_path / "ref", full_every=3)
    ref.run(7)
    comp = _mk(tmp_path / "c", full_every=3, recovery="compute")
    comp.run(4)
    comp.inject_failure([1, 2], hardware=True)
    rep = comp.recover(FaultScript(hardware=True))
    assert rep.recovered_from == "compute_replay" and rep.rolled_back_iterations == 0
    comp.run(3)
    assert _state_equal(comp.state, ref.state)


def test_full_checkpoints_cross_between_the_packages(tmp_path):
    """A full checkpoint written by either package loads in the other, and
    both write the same .npz keys and the same CRC manifest for one state."""
    j, t = _pair(tmp_path)
    j_eng, t_eng = j.workers[0].engine, t.workers[0].engine
    for eng, clu in ((j_eng, j), (t_eng, t)):
        eng.maybe_full_checkpoint(0, clu.state, force=True)
        eng.writer.drain()
    j_path, t_path = j_eng._full_path(0), t_eng._full_path(0)
    assert sorted(np.load(j_path).files) == sorted(np.load(t_path).files)
    manifests = [json.loads(p.with_suffix(".manifest.json").read_text())
                 for p in (j_path, t_path)]
    assert manifests[0] == manifests[1]

    # the reference's checkpoint into the port (after a step moved its state)
    like = jax.tree.map(np.asarray, j.state)
    t.run(1)
    assert not _state_equal(t.state, like)
    t.load_state(load_pytree(j_path, t.state))
    assert _state_equal(t.state, like)
    # ... and the port's into the reference
    restored = j_load_pytree(t_path, like)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(like)):
        np.testing.assert_array_equal(a, b)


def test_step_timing_is_recorded_only_with_a_clock(tmp_path):
    """A host clock given to the cluster times each step's parts into
    `last_step_timing` and changes nothing the simulation computes."""
    ticks = iter(range(10**6))
    plain = _mk(tmp_path / "plain")
    timed = _mk(tmp_path / "timed", clock=lambda: float(next(ticks)))
    for _ in range(2):
        assert plain.step() == timed.step()
        assert plain.last_step_timing == {}
        sp = timed.last_step_timing
        assert set(sp) == {"compute_ms", "device_ms", "flatten_ms", "shard_ms",
                           "fabric_ms", "step_ms"}
        assert sp["device_ms"] is None          # CUDA events only on the card
        parts = [sp[k] for k in ("compute_ms", "flatten_ms", "shard_ms", "fabric_ms")]
        assert all(p >= 1e3 for p in parts) and sp["step_ms"] > sum(parts)
    assert plain.sim_time == timed.sim_time
    assert _state_equal(plain.state, timed.state)


def test_fabric_defaults_are_the_h100_clusters():
    fc = FabricConfig()
    assert (fc.link_bw, fc.dcn_bw) == (hw.FABRIC_LINK_BW, hw.FABRIC_DCN_BW) == (450e9, 50e9)


def test_cluster_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_arch("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimCluster(cfg, ClusterConfig())


def test_public_names_mirror_the_reference():
    import repro
    import repro_torch
    assert repro_torch.__all__ == repro.__all__ and len(repro_torch.__all__) == 21
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name).__name__ == getattr(repro, name).__name__


def test_train_cli_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--smoke",
         "--steps", "6", "--dp", "4", "--inject-failure", "3"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "recovered from neighbor (stream policy)" in proc.stdout
    assert "rollback=0" in proc.stdout and "done: 6 iterations" in proc.stdout


@pytest.mark.cuda
def test_cluster_on_the_card_tracks_the_cpu(tmp_path):
    """The same smoke cluster from the same state on the card (the fp32
    flash kernel under autograd) and on the CPU: losses and the optimizer
    vector at 2e-4 over 3 steps, a recovery in between, bitwise on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = _mk(tmp_path / "cpu")
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32")
    card = SimCluster(cfg, cluster=ClusterConfig(hp=AdamWConfig(**HP),
                                                 **_cluster_kw(tmp_path / "card", 4, 50, 0)))
    assert card.device.type == "cuda"
    card.load_state(tree.tree_map(tree.to_numpy, cpu.state))
    runs = []
    for clu in (cpu, card):
        losses = clu.run(2)
        before = _flatten_opt(clu.state["opt"])[0]
        clu.inject_failure([1])
        assert clu.recover().recovered_from == "neighbor"
        np.testing.assert_array_equal(_flatten_opt(clu.state["opt"])[0], before)
        runs.append((losses + clu.run(1), _flatten_opt(clu.state["opt"])[0]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], **LOSS_TOL)
    np.testing.assert_allclose(runs[1][1], runs[0][1], **LOSS_TOL)
