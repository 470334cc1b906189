"""The adversarial scenario fleet on the port (``repro_torch.runtime.scenarios``),
on the CPU (``device="cpu"``), against the JAX package.

Every scenario of the port's ``corpus()`` replays to the verdicts pinned in
``tests/test_scenario_fleet.py``, field for field, with that file's
structural assertions (zero rollbacks except the adjacent double hardware
failure under the stream policy; detection within one heartbeat period of
the analytic bound). The port's verdicts equal JAX's live ones on the same
scenarios, its ``random_scenario`` equals the reference's, and the port's
versions of the fleet's other tests hold. The dp=8 scenarios carry the
``slow`` marker, as in the reference.
"""
import dataclasses
import inspect
import tempfile
from pathlib import Path

import pytest
import torch

from repro.runtime import scenarios as j_scenarios
from repro_torch.runtime import scenarios
from repro_torch.runtime.scenarios import (Scenario, corpus, random_scenario,
                                           run_scenario)
from test_scenario_fleet import _SLOW, VERDICTS, _assert_verdict, _params

_CORPUS = {sc.name: sc for sc in corpus()}


def _run(name, path):
    return run_scenario(_CORPUS[name], ckpt_dir=path, device="cpu")


def _analytic(sc: Scenario) -> float:
    r = sc.reliability
    return r.heartbeat_period + r.scan_period + r.notify_latency


def test_corpus_matches_the_references_and_the_pins():
    ref = j_scenarios.corpus()
    assert [sc.name for sc in corpus()] == [sc.name for sc in ref] == list(VERDICTS)
    for got, want in zip(corpus(), ref):
        assert _fields(got) == _fields(want), got.name


def _fields(sc):
    """A scenario as plain data (its events and reliability config are
    classes of each package), compared by value."""
    return dataclasses.asdict(sc)


def test_scenario_defaults_are_the_references_fabric():
    sc = Scenario(name="x")
    assert (sc.link_bw, sc.dcn_bw) == (50e9, 5e9)
    assert _fields(sc) == _fields(j_scenarios.Scenario(name="x"))


@pytest.mark.parametrize("name", _params())
def test_scenario_verdict_pinned_on_the_port(name, tmp_path):
    sc = _CORPUS[name]
    v = _run(name, tmp_path)
    _assert_verdict(v.pinned(), VERDICTS[name], name)
    if name != "hardware_double_stream_rollback":
        assert v.rollbacks == 0 and v.rolled_back_iterations == 0
    if v.detection_latency_s is not None:
        assert abs(v.detection_latency_s - _analytic(sc)) <= \
            sc.reliability.heartbeat_period + 1e-9
        assert v.detection_latency_s > 0


@pytest.mark.parametrize("name", [n for n in VERDICTS if n not in _SLOW])
def test_port_verdict_equals_jax_live_verdict(name, tmp_path):
    """Cross-package, on the same scenario: the port's pinned dict equals
    the JAX package's, every field exactly."""
    got = _run(name, tmp_path / "port").pinned()
    want = j_scenarios.run_scenario(j_scenarios.corpus()[list(VERDICTS).index(name)],
                                    ckpt_dir=tmp_path / "jax").pinned()
    assert got == want


def test_rebalanced_stream_beats_static_baseline_on_the_port(tmp_path):
    """The k-path acceptance pin on the port's live verdicts: the
    re-balanced brown-out stream finishes strictly faster than its static
    twin, moves chunks between paths, and delivers the same bytes; the k=3
    cross-pod stripe re-balances without duplicate bytes."""
    reb = _run("mid_transfer_degradation", tmp_path / "r").pinned()
    sta = _run("mid_transfer_degradation_static", tmp_path / "s").pinned()
    assert reb["stream_seconds"] < sta["stream_seconds"]
    assert reb["rebalances"] >= 1 and reb["chunks_rebalanced"] >= 1
    assert sta["rebalances"] == 0 and sta["chunks_rebalanced"] == 0
    assert reb["state_bytes_streamed"] == sta["state_bytes_streamed"]
    k3r = _run("cross_pod_k3_rebalance", tmp_path / "k3r").pinned()
    k3s = _run("cross_pod_k3_stripe", tmp_path / "k3s").pinned()
    assert k3r["rebalances"] >= 1
    assert k3r["state_bytes_streamed"] == k3s["state_bytes_streamed"]


def test_detection_latency_deterministic_across_replays_on_the_port(tmp_path):
    a = _run("clean_software_failure", tmp_path / "a").pinned()
    b = _run("clean_software_failure", tmp_path / "b").pinned()
    assert a == b
    assert a["detection_latency_s"] == b["detection_latency_s"]


def test_missed_detection_raises_the_references_error(tmp_path):
    """A liveness loop that never detects: the runner gives up after its
    budget of idle windows with the reference's AssertionError."""
    sc = _CORPUS["clean_software_failure"]
    clu = scenarios.build_cluster(sc, tmp_path, device="cpu")
    runner = scenarios._Runner(sc, clu)
    clu.inject_failure([1])
    clu.reliability.tick = lambda now: []          # the scan never runs
    with pytest.raises(AssertionError, match=r"not detected within \d+ idle windows"):
        runner.wait_for_detection()


def test_unknown_action_raises(tmp_path):
    sc = Scenario(name="bad", steps=2, events=(scenarios.ev(1, "explode"),))
    with pytest.raises(ValueError, match="unknown scenario action"):
        run_scenario(sc, ckpt_dir=tmp_path, device="cpu")


def test_run_scenario_without_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(_CORPUS["clean_software_failure"], ckpt_dir=tmp_path)


def test_default_checkpoint_directory_is_under_the_temp_dir():
    default = inspect.signature(run_scenario).parameters["ckpt_dir"].default
    assert Path(default).parent == Path(tempfile.gettempdir())


def test_cluster_weights_come_from_the_host_generator(tmp_path):
    """A scenario's cluster draws its weights from a host generator seeded
    with the scenario's seed, whatever its device, so that the same
    scenario trains the same model on the card and on the CPU."""
    from repro_torch.models import build_model
    sc = _CORPUS["clean_software_failure"]
    clu = scenarios.build_cluster(sc, tmp_path, device="cpu")
    want = build_model(scenarios._tiny_arch(), device="cpu").init(
        torch.Generator().manual_seed(sc.seed))
    got = dict(clu.model.named_parameters())
    assert set(got) == set(dict(want.named_parameters()))
    for name, t in want.named_parameters():
        assert torch.equal(got[name].detach(), t.detach()), name


@pytest.mark.cuda
def test_scenario_on_the_card_trains_as_on_the_cpu(tmp_path):
    """One scenario replayed on the card (the fp32 flash kernel under
    autograd) and on the CPU from nothing but its seed: the same verdict,
    and every step's loss within the fp32 tolerance (2e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = _CORPUS["clean_software_failure"]
    runs = []
    for device in ("cpu", "cuda"):
        clu = scenarios.build_cluster(sc, tmp_path / device, device=device)
        runs.append((scenarios._Runner(sc, clu).run().pinned(), clu.loss_history))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == sc.steps
    torch.testing.assert_close(torch.tensor(runs[1][1]), torch.tensor(runs[0][1]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234, 9999])
def test_random_scenario_is_the_references(seed):
    assert _fields(random_scenario(seed)) == _fields(j_scenarios.random_scenario(seed))


try:
    import hypothesis  # noqa: F401
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @pytest.mark.slow
    @given(st.integers(0, 10_000))
    @settings(max_examples=4, deadline=None,
              suppress_health_check=[HealthCheck.too_slow], derandomize=True)
    def test_random_scenarios_hold_fleet_invariants_on_the_port(seed):
        """Seeded random gray-failure scenarios on the port: the same
        scenario as the reference's generator, every recovery rollback-free,
        detection on-bound, the run complete."""
        sc = random_scenario(seed)
        assert _fields(sc) == _fields(j_scenarios.random_scenario(seed))
        with tempfile.TemporaryDirectory() as d:
            v = run_scenario(sc, ckpt_dir=d, device="cpu")
        assert v.steps_completed == sc.steps
        assert v.rollbacks == 0 and v.rolled_back_iterations == 0
        n_fails = sum(1 for e in sc.events if e.action == "fail")
        assert v.recoveries == n_fails
        if v.detection_latency_s is not None:
            assert 0 < v.detection_latency_s <= _analytic(sc) + \
                sc.reliability.heartbeat_period + 1e-9
