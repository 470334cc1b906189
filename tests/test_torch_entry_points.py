"""The port's remaining single-card entry points against the JAX package, on
the CPU: the dense configs (field for field, and ``param_count`` at full
width from the shapes alone), the framework-free analytic modules
(``core/analytic.py``, ``core/fcr.py``, ``razor_bytes_formula``) on seeded
random inputs, the four examples and the train CLI on gemma-2b, mamba2-2.7b
and zamba2-7b."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_arch as j_get_arch
from repro.core import analytic as j_analytic
from repro.core import fcr as j_fcr
from repro.core.lccl import LinkTopology as JLinkTopology
from repro.core.lccl import PodFabric as JPodFabric
from repro.core.razor import razor_bytes_formula as j_razor_bytes_formula
from repro.models.transformer import param_count as j_param_count
from repro_torch.configs import get_arch
from repro_torch.core import analytic, fcr
from repro_torch.core.lccl import LinkTopology, PodFabric
from repro_torch.core.razor import razor_bytes_formula
from repro_torch.models import param_count
from repro_torch.roofline import hw

ROOT = Path(__file__).resolve().parent.parent
DENSE = ("gemma-2b", "gpt2-2.7b", "llama3-8b", "llama2-13b", "llama3-70b",
         "deepseek-67b", "nemotron-4-15b", "qwen3-0.6b")
HYP = settings(max_examples=40, deadline=None, derandomize=True)
FLOAT_TOL = dict(rtol=1e-12, atol=0.0)


# -------------------------------- configs -------------------------------- #
@pytest.mark.parametrize("name", DENSE)
def test_dense_config_is_the_references(name):
    got, want = get_arch(name), j_get_arch(name)
    kept = [f.name for f in dataclasses.fields(got)]
    assert {k: getattr(got, k) for k in kept} == {k: getattr(want, k) for k in kept}
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.padded_vocab == want.padded_vocab


@pytest.mark.parametrize("name", DENSE)
def test_param_count_at_full_width_is_the_references(name):
    """Counted from the shapes (the port builds on the meta device, the
    reference from its parameter specs): no weight is allocated."""
    assert param_count(get_arch(name)) == j_param_count(j_get_arch(name))


# -------------------------------- analytic ------------------------------- #
pos = st.floats(1e-3, 1e6, allow_nan=False)
rate = st.floats(1e6, 1e15, allow_nan=False)


@HYP
@given(s=pos, b=pos, phi=pos, c=rate, v=rate, i=rate)
def test_checkpoint_times_are_the_references(s, b, phi, c, v, i):
    np.testing.assert_allclose(analytic.compute_time(s, b, phi, c),
                               j_analytic.compute_time(s, b, phi, c), **FLOAT_TOL)
    np.testing.assert_allclose(analytic.ckpt_time_full(phi, v, i),
                               j_analytic.ckpt_time_full(phi, v, i), **FLOAT_TOL)
    np.testing.assert_allclose(analytic.ckpt_time_razor(phi, v),
                               j_analytic.ckpt_time_razor(phi, v), **FLOAT_TOL)


@HYP
@given(t_ckpt=st.floats(0, 1e4), interval=pos, mttr=pos, mtbf=pos)
def test_mfu_loss_is_the_references(t_ckpt, interval, mttr, mtbf):
    got = analytic.mfu_loss(t_ckpt, interval, mttr, mtbf)
    want = j_analytic.mfu_loss(t_ckpt, interval, mttr, mtbf)
    assert (got.ckpt, got.recover, got.rollback, got.total) == \
        (want.ckpt, want.recover, want.rollback, want.total)


@HYP
@given(n=st.integers(1, 20_000), hours=st.floats(0.0, 1e4),
       mtbf=st.floats(1.0, 1e6))
def test_failure_probabilities_are_the_references(n, hours, mtbf):
    assert analytic.cluster_failure_probability(n, hours, mtbf) == \
        j_analytic.cluster_failure_probability(n, hours, mtbf)
    assert analytic.cluster_mtbf_hours(n, mtbf) == j_analytic.cluster_mtbf_hours(n, mtbf)


@HYP
@given(n=st.integers(2, 4096), k=st.integers(0, 64), hours=st.floats(0.1, 200.0),
       gpus=st.sampled_from([1, 4, 8]))
def test_recovery_probability_is_the_references(n, k, hours, gpus):
    assert analytic.recovery_prob_given_k(n, k) == j_analytic.recovery_prob_given_k(n, k)
    assert analytic.k_failure_prob(n, k, hours, gpus_per_host=gpus) == \
        j_analytic.k_failure_prob(n, k, hours, gpus_per_host=gpus)
    assert analytic.recovery_probability(n, hours, gpus_per_host=gpus) == \
        j_analytic.recovery_probability(n, hours, gpus_per_host=gpus)


@pytest.mark.parametrize("n,hours,m", [(64, 24.0, 2), (256, 72.0, 3)])
def test_gemini_recovery_probability_is_the_references(n, hours, m):
    kw = dict(samples=20_000, seed=3)
    assert analytic.gemini_recovery_probability(n, hours, m, **kw) == \
        j_analytic.gemini_recovery_probability(n, hours, m, **kw)


@HYP
@given(phi=st.integers(0, 10**12), dp=st.integers(-2, 4096))
def test_razor_bytes_formula_is_the_references(phi, dp):
    assert razor_bytes_formula(phi, dp) == j_razor_bytes_formula(phi, dp)


# ---------------------------------- FCR ---------------------------------- #
@HYP
@given(s=st.integers(1, 1 << 17), gb=st.integers(1, 4096), dp=st.integers(1, 512),
       v=rate, c=rate)
def test_fcr_is_the_references(s, gb, dp, v, c):
    assert fcr.fcr(s, gb / dp, v, c) == j_fcr.fcr(s, gb / dp, v, c)
    assert fcr.is_free(s, gb / dp, v, c) == j_fcr.is_free(s, gb / dp, v, c)
    # the reference's figures passed explicitly: the same function
    assert fcr.tpu_fcr(s, gb, dp, link_bw=v, peak_flops=c) == \
        j_fcr.tpu_fcr(s, gb, dp, link_bw=v, peak_flops=c)


def test_tpu_fcr_defaults_are_the_h100s():
    assert fcr.tpu_fcr(1024, 8, 4) == fcr.fcr(1024, 2, hw.FABRIC_LINK_BW,
                                              hw.PEAK_FLOPS["bfloat16"])


def test_fcr_sweep_is_the_references():
    args = ([512, 4096], [1, 8], [25e9, 50e9], [197e12, 989e12])
    got = [(x.value, x.free) for x in fcr.sweep(*args)]
    want = [(x.value, x.free) for x in j_fcr.sweep(*args)]
    assert got == want and len(got) == 16


@pytest.mark.parametrize("pods,size,ici,dcn,lat", [
    (3, 4, 50e9, 5e9, 0.0), (2, 2, 1e9, 1e8, 0.0), (2, 4, 1e6, 1e6, 0.25)])
def test_fcr_per_tier_on_the_same_pod_fabric(pods, size, ici, dcn, lat):
    kw = dict(dcn_latency=lat, quantum=1e4)
    port, ref = PodFabric(pods, size, ici, dcn, **kw), JPodFabric(pods, size, ici, dcn, **kw)
    s, b, c = 4096, 2, 197e12
    assert fcr.fcr_per_tier(port, s, b, c) == j_fcr.fcr_per_tier(ref, s, b, c)
    assert fcr.fcr_hidden_per_tier(port, s, b, c, phi=1e6, quantum=1e4) == \
        j_fcr.fcr_hidden_per_tier(ref, s, b, c, phi=1e6, quantum=1e4)


@HYP
@given(s=st.integers(64, 8192), b=st.integers(1, 8), v=st.floats(1e7, 1e12),
       c=st.floats(1e12, 1e15), lat=st.sampled_from([0.0, 1e-3]))
def test_fcr_hidden_emergent_is_the_references(s, b, v, c, lat):
    kw = dict(phi=1e6, quantum=1e5, latency=lat)
    assert fcr.fcr_hidden_emergent(s, b, v, c, **kw) == \
        j_fcr.fcr_hidden_emergent(s, b, v, c, **kw)


def test_fcr_hidden_per_edge_on_the_same_ring():
    hot = {(1, 2): 1e7}
    port = LinkTopology(4, 1e9, quantum=1e5, edge_bw=hot)
    ref = JLinkTopology(4, 1e9, quantum=1e5, edge_bw=hot)
    args = (2048, 2, 1e12)       # FCR 2.05 on a 1e9 edge, 0.02 on the hotspot
    kw = dict(phi=1e6, quantum=1e5, train_traffic=[(0.0, 1e5)])
    got = fcr.fcr_hidden_per_edge(port, *args, **kw)
    assert got == j_fcr.fcr_hidden_per_edge(ref, *args, **kw)
    assert not got[(1, 2)] and all(h for e, h in got.items() if e != (1, 2))


# ----------------------------- examples / CLI ----------------------------- #
def _run(*args, timeout=300):
    # one intra-op thread: under pytest-xdist every worker's torch already
    # spreads over all cores, and a subprocess with a full thread pool of its
    # own slows down many times over (the same losses either way)
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          cwd=ROOT, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_quickstart_example_on_cpu():
    out = _run("repro_torch.examples.quickstart", "--device", "cpu")
    assert "recovered from neighbor; rollback = 0 iterations" in out
    assert "done — instant checkpoints taken: 10" in out


def test_elastic_rescale_example_on_cpu():
    out = _run("repro_torch.examples.elastic_rescale", "--device", "cpu")
    assert "new dp=3, global batch -> 6" in out
    assert "exact-cover data partition preserved after rescale — OK" in out


def test_train_with_failover_example_on_cpu():
    """8 steps: the example asserts that the last loss is below the first,
    and at 4 (its failure at step 2, the learning rate still warming up over
    20 steps) that comparison is batch noise in both packages. At 8 it is
    still one noisy comparison during warm-up (10.4689 -> 10.4463 here, a
    0.02 margin; the reference's example fails it at 8), so this test's pass
    rests on that margin: a change of batch order or seed can flip it
    without any fault in the port."""
    out = _run("repro_torch.examples.train_with_failover", "--device", "cpu",
               "--steps", "8", timeout=600)
    assert "model: 64.2M params, dp=4, seq 128" in out
    assert "[4] recovered via neighbor, rollback=0" in out
    assert "training improved the loss through a failure — OK" in out
    assert "resumed: reused 4 partial chunks" in out and "rollback=0" in out
    assert "trained 5 more steps after double failure" in out


def test_serve_decode_example_on_cpu():
    out = _run("repro_torch.examples.serve_decode", "--device", "cpu")
    assert "qwen3-0.6b: generated (4, 12) tokens" in out and "via KV cache" in out
    assert "mamba2-2.7b: generated (4, 12) tokens" in out and "via SSM state" in out


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_train_cli_on_the_ssm_and_hybrid_smoke(arch):
    out = _run("repro_torch.launch.train", "--arch", arch, "--device", "cpu",
               "--smoke", "--steps", "6", "--inject-failure", "3")
    assert "recovered from neighbor" in out and "rollback=0" in out
    assert "done: 6 iterations" in out


def test_train_cli_on_gemma_smoke():
    out = _run("repro_torch.launch.train", "--arch", "gemma-2b", "--device", "cpu",
               "--smoke", "--steps", "8", "--inject-failure", "4")
    assert "recovered from neighbor" in out and "rollback=0" in out
    assert "done: 8 iterations" in out


@pytest.mark.parametrize("smoke", [True, False])
def test_train_cli_runs_the_config_without_recompute(monkeypatch, tmp_path, smoke):
    """As the reference's CLI does, the port's hands its ``SimCluster`` the
    config with ``remat_policy="none"`` (the registered config says "full"),
    smoke or not: the cluster is replaced by one that records its config."""
    from repro_torch.launch import train
    from repro_torch.runtime import cluster

    class Built(Exception):
        pass

    def record(cfg, **kwargs):
        raise Built(cfg)
    monkeypatch.setattr(cluster, "SimCluster", record)
    argv = ["--arch", "gemma-2b", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(Built) as built:
        train.main(argv + (["--smoke"] if smoke else []))
    from repro_torch.configs import reduce_for_smoke
    registered = get_arch("gemma-2b")
    assert registered.remat_policy == "full"
    want = reduce_for_smoke(registered) if smoke else registered
    assert built.value.args[0] == dataclasses.replace(want, remat_policy="none")
