"""gpt2-2.7b (the paper's Table 4 GPT-2 2.7B: dense, MHA 32/32 at head_dim
80, the gelu MLP, vocab 50,257 padded to 50,432, untied head) in the port
against the JAX package, at smoke width on the CPU: the reference's
parameters (``repro`` init, moved across with ``params_from_numpy``)
through JAX ``prefill`` / ``decode_step`` / ``loss`` and the port's. The
smoke config keeps head_dim 80 (``reduce_for_smoke`` cuts it to 16): 4
heads of 80, d_model 320, 2 layers, fp32, 2e-4. Both packages give the
dense family RMSNorm and RoPE, not GPT-2's LayerNorm and learned
positions."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import build_model as j_build_model
from repro.models import param_count as j_param_count
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime.cluster import ClusterConfig as JClusterConfig
from repro.runtime.cluster import FabricConfig as JFabricConfig
from repro.runtime.cluster import SimCluster as JSimCluster
from repro.runtime.recovery import _flatten_opt as j_flatten_opt
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attn, flash_attention
from repro_torch.models import build_model, param_count
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.cluster import ClusterConfig, FabricConfig, SimCluster
from repro_torch.runtime.recovery import _flatten_opt
from repro_torch.train.serve import build_decode_step, build_prefill_step
from repro_torch.train.state import grad_tree

ARCH = "gpt2-2.7b"
B, S, STEPS = 2, 12, 8
MAX_LEN = S + STEPS + 1
TOL = dict(rtol=2e-4, atol=2e-4)      # the serving slice's fp32 tolerance
HD80 = dict(d_model=320, num_heads=4, num_kv_heads=4, head_dim=80, dtype="float32")
# the reference's fabric and schedule, as tests/test_torch_cluster.py passes them
FABRIC = dict(link_bw=50e9, dcn_bw=5e9)
HP = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _cfgs():
    return (dataclasses.replace(j_reduce(j_get_arch(ARCH)), **HD80),
            dataclasses.replace(reduce_for_smoke(get_arch(ARCH)), **HD80))


@pytest.fixture(scope="module")
def runs():
    """JAX and port runs of prefill + STEPS greedy decode steps (the
    port fed JAX's tokens), from one parameter tree; the port's model."""
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S))
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t, "max_len": MAX_LEN}))
    jdecode = jax.jit(jmodel.decode_step)
    jlogits, jcache = jprefill(params, jnp.asarray(tokens, jnp.int32))
    ref = {"prefill": np.asarray(jlogits),
           "cache": {k: np.asarray(v) for k, v in jcache.items()}, "decode": [], "tokens": []}
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        ref["tokens"].append(np.asarray(tok))
        jlogits, jcache = jdecode(params, jcache, tok)
        ref["decode"].append(np.asarray(jlogits))
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ref["final"] = {k: np.asarray(v) for k, v in jcache.items()}

    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    launches = (flash_attention.flash_attention.launches,
                decode_attn.decode_attention.launches)
    logits, cache = prefill(torch.from_numpy(tokens), MAX_LEN)
    port = {"prefill": logits.numpy(),
            "cache": {"k": cache["k"].numpy().copy(), "v": cache["v"].numpy().copy(),
                      "index": cache["index"]},
            "decode": [], "tokens": []}
    tok = logits.argmax(-1)
    for step in range(STEPS):
        port["tokens"].append(tok.numpy())
        logits, cache = decode(cache, torch.tensor(ref["tokens"][step], dtype=torch.long))
        port["decode"].append(logits.numpy())
        tok = logits.argmax(-1)
    port["final"] = {"k": cache["k"].numpy(), "v": cache["v"].numpy(),
                     "index": cache["index"]}
    port["launches"] = (flash_attention.flash_attention.launches - launches[0],
                        decode_attn.decode_attention.launches - launches[1])
    return jmodel, params, model, ref, port


def test_smoke_config_keeps_head_dim_80():
    """The smoke config is the reference's with 4 heads of 80 (MHA), the
    gelu MLP (``w_up``, ``w_down``, no gate) and the untied head; the two
    packages' configs agree field for field."""
    jcfg, tcfg = _cfgs()
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert tcfg.resolved_head_dim == 80 and tcfg.num_heads == tcfg.num_kv_heads
    assert tcfg.mlp_type == "gelu" and not tcfg.use_qk_norm and not tcfg.tie_embeddings
    model = build_model(tcfg, device="meta")
    assert sorted(model.blocks[0].mlp.keys()) == ["w_down", "w_up"]
    assert tuple(model.lm_head["w"].shape) == (tcfg.padded_vocab, tcfg.d_model)


def test_prefill_logits_match_jax(runs):
    *_, ref, port = runs
    assert port["prefill"].shape == ref["prefill"].shape == (B, 256)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)


def test_cpu_run_launches_no_kernel(runs):
    """On CPU tensors every attention call site takes the plain version:
    no launch is counted."""
    *_, port = runs
    assert port["launches"] == (0, 0)


@pytest.mark.parametrize("when", ["cache", "final"])
@pytest.mark.parametrize("name", ["k", "v"])
def test_caches_match_jax(runs, name, when):
    """The caches after the prefill and after the decode steps: (layers, B,
    max_len, 4 kv heads, 80)."""
    *_, ref, port = runs
    assert port[when][name].shape == ref[when][name].shape == (2, B, MAX_LEN, 4, 80)
    np.testing.assert_allclose(port[when][name], ref[when][name], **TOL)


def test_index_after_prefill_and_steps(runs):
    *_, ref, port = runs
    assert port["cache"]["index"] == int(ref["cache"]["index"]) == S
    assert port["final"]["index"] == int(ref["final"]["index"]) == S + STEPS


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_logits_and_greedy_tokens_match_jax(runs, step):
    *_, ref, port = runs
    np.testing.assert_allclose(port["decode"][step], ref["decode"][step], **TOL)
    np.testing.assert_array_equal(port["tokens"][step], ref["tokens"][step])


def test_loss_and_every_gradient_match_jax(runs):
    """The loss of 2 x 17 tokens (xent through the untied head, aux 0) and
    all 11 gradients (embed, lm_head, final_norm, 8 a stacked block: the
    four attention projections, the two norms, w_up and w_down)."""
    jmodel, params, model, _, _ = runs
    tokens = np.random.default_rng(5).integers(0, 256, (2, 17))
    (jl, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)}),
        has_aux=True))(params)
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss, aux = model.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert aux["aux"].item() == 0.0
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(port) == len(ref) == 3 + 8
    for (path, got), (_, want) in zip(port, ref):
        assert np.abs(want).max() > 0, tree.keystr(path)
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path), **TOL)
    model.requires_grad_(False)


def test_full_config_and_param_count_match_jax():
    """The full config field for field, and 2,774,960,640 parameters (5.55
    GB of bf16) on both packages; 2 of its 32 layers, the cut the card's
    slice and training phases take, are 415,511,040."""
    tcfg, jcfg = get_arch(ARCH), j_get_arch(ARCH)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    n = param_count(tcfg)
    assert n == j_param_count(jcfg)
    assert n == 2_774_960_640
    assert (tcfg.resolved_head_dim, tcfg.padded_vocab, tcfg.remat_policy) == (80, 50432, "full")
    cut = dataclasses.replace(tcfg, num_layers=2)
    assert param_count(cut) == j_param_count(dataclasses.replace(jcfg, num_layers=2))
    assert param_count(cut) == 415_511_040


def test_cluster_step_failure_and_stream_recovery_match_jax(tmp_path):
    """SimCluster at the smoke size (dp 4, 8 x 16 tokens a step) from one
    state on both packages: 2 steps, a software failure of worker 2, the
    stream policy's recovery, 1 step. The losses track JAX's, the
    RecoveryReport is the reference's field for field, the port's opt
    vector is bitwise the one before the failure and tracks JAX's."""
    jcfg, tcfg = _cfgs()
    kw = dict(dp=4, global_batch=8, seq_len=16, full_every=50, seed=0)
    j = JSimCluster(jcfg, cluster=JClusterConfig(hp=JAdamWConfig(**HP), ckpt_dir=tmp_path / "j",
                                                 **kw),
                    fabric=JFabricConfig(**FABRIC), recovery="stream")
    t = SimCluster(tcfg, cluster=ClusterConfig(hp=AdamWConfig(**HP), ckpt_dir=tmp_path / "t",
                                               **kw),
                   fabric=FabricConfig(**FABRIC), recovery="stream", device="cpu")
    t.load_state(jax.tree.map(np.asarray, j.state))
    losses, reports = [], []
    for clu in (j, t):
        run = clu.run(2)
        before = (_flatten_opt if clu is t else j_flatten_opt)(clu.state["opt"])[0]
        clu.inject_failure([2])
        reports.append(clu.recover())
        if clu is t:
            np.testing.assert_array_equal(_flatten_opt(t.state["opt"])[0], before)
        losses.append(list(run) + list(clu.run(1)))
    assert dataclasses.asdict(reports[1]) == dataclasses.asdict(reports[0])
    assert reports[1].recovered_from == "neighbor" and reports[1].rolled_back_iterations == 0
    np.testing.assert_allclose(losses[1], losses[0], **TOL)
    assert t.iteration == j.iteration == 3 and t.sim_time == j.sim_time
    np.testing.assert_allclose(_flatten_opt(t.state["opt"])[0],
                               j_flatten_opt(j.state["opt"])[0], **TOL)


def test_cli_smoke_on_cpu():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke",
         "--arch", ARCH], capture_output=True, text=True, cwd=root, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "decoded 16 tokens/seq" in proc.stdout
