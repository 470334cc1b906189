"""The port's MoE family against the JAX package on the CPU, for both MoE
configs (qwen2-moe-a2.7b: 8 routed experts padded to 16, top-2, a shared
expert; qwen3-moe-30b-a3b: 8 padded to 16, top-2, GQA and qk-norm) at their
smoke size: ``moe_apply`` with dropped assignments, dropless and in bf16,
with every gradient; the MoE ``DecoderLM`` (forward, prefill and decode,
the loss with its balance term and every gradient); the parameter counts,
config copies, ``.npz`` keys and the opt vector; five ``SimCluster`` steps
through a recovery; the sharded step at one batch rank (more batch ranks
and a "model" axis: tests/test_torch_moe_step.py); and the CLIs. Inputs are made from numpy seeds and the same reference
parameters (``repro`` init, moved across with ``params_from_numpy``) go
through both packages.

Tolerances: fp32 at 2e-4 (the reference's test_prefill_decode_matches_forward),
bf16 at 2e-2 of each leaf's largest magnitude (the bf16 tolerance of
tests/test_kernels.py, per leaf as tests/test_torch_train.py holds the bf16
gradients)."""
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
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.ckpt import storage as j_storage
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.launch.mesh import make_mesh_compat
from repro.models import active_param_count as j_active_param_count
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models import param_count as j_param_count
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime.cluster import ClusterConfig as JClusterConfig
from repro.runtime.cluster import FabricConfig as JFabricConfig
from repro.runtime.cluster import SimCluster as JSimCluster
from repro.runtime.recovery import _flatten_opt as j_flatten_opt
from repro.train.state import init_state as j_init_state
from repro.train.step import build_train_step as j_build_train_step
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt import storage
from repro_torch.configs import ShapeConfig, get_arch, reduce_for_smoke
from repro_torch.launch.mesh import make_single_device_mesh
from repro_torch.models import active_param_count, build_model, moe, param_count
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import join_tree
from repro_torch.runtime.cluster import ClusterConfig, FabricConfig, SimCluster
from repro_torch.runtime.recovery import _flatten_opt
from repro_torch.train.serve import build_decode_step, build_prefill_step
from repro_torch.train.state import grad_tree, param_tree, shard_init_state
from repro_torch.train.step import build_train_step

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 2e-2
B, S, STEPS = 2, 11, 8
MAX_LEN = S + STEPS + 1
HOT = 3                      # the expert a shifted router makes hot
HYP = settings(max_examples=200, deadline=None, derandomize=True)


def _cfgs(arch, dtype="float32", **kw):
    jcfg = dataclasses.replace(j_reduce(j_get_arch(arch)), dtype=dtype, **kw)
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype=dtype, **kw)
    return jcfg, tcfg


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _leaf_of(node, path):
    for key in path:
        node = node[key]
    return node


# ------------------------------ moe_apply -------------------------------- #
def _moe_case(arch, case):
    """The reference's MoE parameters and an input (2, 128, 64): 16 groups
    of 16 tokens at capacity 8. "drops": the router shifted toward expert
    HOT and the input given a positive mean, so every token picks HOT and
    each group drops 8 of its assignments to it; "dropless": the same at
    capacity_factor 8 (capacity 16); "bf16": the drop case in bf16."""
    dtype = "bfloat16" if case == "bf16" else "float32"
    kw = {"capacity_factor": 8.0} if case == "dropless" else {}
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    jdt = jnp.bfloat16 if case == "bf16" else jnp.float32
    p = jax.tree.map(lambda a: np.array(a), j_moe.moe_init(jax.random.key(5), jcfg, jdt))
    p["router"][:, HOT] += 0.3
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 128, 64)) + 0.5).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    if case == "bf16":
        x = x.astype(jnp.bfloat16)
    return jcfg, tcfg, p, x, gy


def _jax_moe(jcfg, p, x, gy):
    """out, aux and the gradients of sum(out * gy) + 0.7 aux w.r.t. the
    parameters and x, by jax.grad of the reference's moe_apply."""
    def f(p, x):
        out, aux = j_moe.moe_apply(p, jcfg, x)
        return jnp.sum(out.astype(jnp.float32) * gy) + 0.7 * aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(x))
    return out, aux, gp, gx


def _port_moe(tcfg, p, x, gy, device="cpu"):
    dtype = torch.bfloat16 if tcfg.dtype == "bfloat16" else torch.float32

    def leaf(a):
        return torch.tensor(np.asarray(a, np.float32), dtype=torch.float32 if a.dtype == np.float32
                            else dtype, device=device, requires_grad=True)

    tp = jax.tree.map(leaf, p)
    tx = torch.tensor(np.asarray(x, np.float32), dtype=dtype, device=device,
                      requires_grad=True)
    with moe.record_routing() as log:
        out, aux = moe.moe_apply(tp, tcfg, tx)
    ((out.float() * torch.from_numpy(gy).to(device)).sum() + 0.7 * aux).backward()
    return out, aux, tp, tx, log


def _assert_grads(tp, gp, tol, per_leaf_scale):
    flat = jax.tree_util.tree_flatten_with_path(gp)[0]
    assert len(flat) == (8 if "shared" in tp else 4)
    for path, want in flat:
        keys = [k.key for k in path]
        got = _np(_leaf_of(tp, keys).grad)
        want = np.asarray(want, np.float32)
        assert np.isfinite(got).all(), keys
        atol = tol * np.abs(want).max() if per_leaf_scale else tol
        np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=str(keys))


@pytest.mark.parametrize("case", ["drops", "dropless", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_every_gradient_match_jax(arch, case):
    """out, the balance loss, dx and the gradient of every leaf (the
    router's through the top-k weights and the mean of the gate only)
    against jax.grad of the reference's moe_apply."""
    jcfg, tcfg, p, x, gy = _moe_case(arch, case)
    jout, jaux, jgp, jgx = _jax_moe(jcfg, p, x, gy)
    out, aux, tp, tx, log = _port_moe(tcfg, p, x, gy)
    assert out.dtype == (torch.bfloat16 if case == "bf16" else torch.float32)
    cap = log[0]["capacity"]
    assert cap == (16 if case == "dropless" else 8)
    dropped = int((~log[0]["valid"]).sum())
    assert (dropped == 0) if case == "dropless" else (dropped >= 16 * 8)
    if case == "bf16":
        np.testing.assert_allclose(_np(out), _np(jout), rtol=BF16_TOL,
                                   atol=BF16_TOL * np.abs(_np(jout)).max())
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_allclose(_np(tx.grad), _np(jgx), rtol=BF16_TOL,
                                   atol=BF16_TOL * np.abs(_np(jgx)).max())
        _assert_grads(tp, jgp, BF16_TOL, per_leaf_scale=True)
    else:
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
        np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
        np.testing.assert_allclose(_np(tx.grad), _np(jgx), **TOL)
        _assert_grads(tp, jgp, TOL["rtol"], per_leaf_scale=False)


def _reference_routing(jcfg, p, x):
    """top_e and the capacity positions as the reference's moe_apply
    computes them (its routing and position lines, repro/models/moe.py
    :79-98, run by JAX on the same input)."""
    b, s, d = x.shape
    t, e, k = b * s, jcfg.padded_experts, jcfg.top_k
    grp = j_moe.moe_groups(t)
    tg = t // grp
    logits = jnp.asarray(x, jnp.float32).reshape(grp, tg, d) @ p["router"]
    logits = jnp.where((jnp.arange(e) >= jcfg.num_experts)[None, None], -1e30, logits)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_e = top_e.reshape(grp, tg * k)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    first = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(e)))(sorted_e)
    pos_sorted = jnp.arange(tg * k)[None, :] - jnp.take_along_axis(first, sorted_e, axis=1)
    pos = jnp.zeros((grp, tg * k), jnp.int32).at[
        jnp.arange(grp)[:, None], order].set(pos_sorted.astype(jnp.int32))
    return np.asarray(top_e), np.asarray(pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_positions_and_drops_match_the_references(arch):
    """On the input that drops: the reference itself drops (its output
    differs from its dropless output), and the port's top_e, positions
    (group-local, from a stable sort) and valid mask equal the reference's;
    no padded expert is ever picked."""
    jcfg, tcfg, p, x, gy = _moe_case(arch, "drops")
    jout = np.asarray(j_moe.moe_apply(p, jcfg, jnp.asarray(x))[0])
    jout_dropless = np.asarray(j_moe.moe_apply(
        p, dataclasses.replace(jcfg, capacity_factor=8.0), jnp.asarray(x))[0])
    assert np.abs(jout - jout_dropless).max() > 1e-2
    top_e, pos = _reference_routing(jcfg, p, x)
    *_, log = _port_moe(tcfg, p, x, gy)
    rec = log[0]
    np.testing.assert_array_equal(rec["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(rec["pos"].numpy(), pos)
    np.testing.assert_array_equal(rec["valid"].numpy(), pos < rec["capacity"])
    assert int(rec["top_e"].max()) < jcfg.num_experts < jcfg.padded_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_gates_route_as_jax(arch):
    """Experts with equal router columns tie exactly in every token's gate
    probabilities: the port orders them as ``lax.top_k`` does (the lower
    expert first), so its top_e, positions, output and balance loss equal
    the reference's."""
    jcfg, tcfg, p, x, gy = _moe_case(arch, "drops")
    for a, b in ((HOT, HOT + 1), (1, 6)):
        p["router"][:, b] = p["router"][:, a]
    top_e, pos = _reference_routing(jcfg, p, x)
    assert (top_e == HOT).any() and (top_e == HOT + 1).any()   # a tie inside the top-k
    jout, jaux, _, _ = _jax_moe(jcfg, p, x, gy)
    out, aux, _, _, log = _port_moe(tcfg, p, x, gy)
    np.testing.assert_array_equal(log[0]["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(log[0]["pos"].numpy(), pos)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


@HYP
@given(t=st.integers(1, 300_000), experts=st.sampled_from([16, 64, 128]),
       top_k=st.sampled_from([1, 2, 4, 8]), cf=st.sampled_from([1.0, 1.25, 2.0, 8.0]))
def test_groups_and_capacity_match_jax(t, experts, top_k, cf):
    g = moe.moe_groups(t)
    assert g == j_moe.moe_groups(t)
    assert moe.moe_capacity(t // g, experts, top_k, cf) == \
        j_moe.moe_capacity(t // g, experts, top_k, cf)


# ------------------------------- the model ------------------------------- #
def _pair(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jmodel, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jmodel, params, model = _pair(arch)
    tokens = np.random.default_rng(2).integers(0, 256, (B, 2 * S))
    want = np.asarray(jmodel.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)}))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (B, 2 * S, 256)
    np.testing.assert_allclose(got, want, **TOL)


def _serve_pair(arch, **kw):
    """JAX and port runs of prefill + STEPS greedy decode steps (tokens
    chosen by JAX), from one parameter tree."""
    jmodel, params, model = _pair(arch, **kw)
    tokens = np.random.default_rng(3).integers(0, 256, (B, S))
    jlogits, jcache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t, "max_len": MAX_LEN}))(
        params, jnp.asarray(tokens, jnp.int32))
    ref = {"prefill": _np(jlogits), "k": _np(jcache["k"]), "v": _np(jcache["v"]),
           "decode": [], "tokens": []}
    jdecode = jax.jit(jmodel.decode_step)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        ref["tokens"].append(np.asarray(tok))
        jlogits, jcache = jdecode(params, jcache, tok)
        ref["decode"].append(_np(jlogits))
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ref["k_final"], ref["v_final"] = _np(jcache["k"]), _np(jcache["v"])
    logits, cache = build_prefill_step(model)(torch.from_numpy(tokens), MAX_LEN)
    port = {"prefill": _np(logits), "k": _np(cache["k"]).copy(), "v": _np(cache["v"]).copy(),
            "decode": []}
    decode = build_decode_step(model)
    for step in range(STEPS):
        logits, cache = decode(cache, torch.tensor(ref["tokens"][step], dtype=torch.long))
        port["decode"].append(_np(logits))
    port["k_final"], port["v_final"] = _np(cache["k"]), _np(cache["v"])
    assert cache["index"] == S + STEPS
    return ref, port, model, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_dropless(arch):
    """Prefill, the KV cache and 8 greedy decode steps at capacity_factor
    8.0, as the reference's test_prefill_decode_matches_forward runs the
    MoE (dropless, so the capacity cannot differ across contexts); and
    prefill + decode equal the port's own forward."""
    ref, port, model, tokens = _serve_pair(arch, capacity_factor=8.0)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)
    for name in ("k", "v", "k_final", "v_final"):
        np.testing.assert_allclose(port[name], ref[name], err_msg=name, **TOL)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], ref["decode"][step], **TOL)
        if step + 1 < STEPS:
            np.testing.assert_array_equal(port["decode"][step].argmax(-1),
                                          ref["tokens"][step + 1])
    seq = np.concatenate([tokens, np.stack(ref["tokens"], 1)], axis=1)
    with torch.inference_mode():
        full = model(torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(port["prefill"], full[:, S - 1], **TOL)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], full[:, S + step], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_at_the_default_capacity(arch):
    ref, port, _, _ = _serve_pair(arch)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], ref["decode"][step], **TOL)


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    jcfg, tcfg = _cfgs(request.param)
    jmodel = j_build_model(jcfg)
    state = j_init_state(jmodel, jax.random.key(1))
    host = jax.tree.map(np.asarray, state)
    model = params_from_numpy(host["params"], tcfg, device="cpu")
    model.requires_grad_(True)
    return jmodel, state, model


def test_loss_aux_and_every_gradient_match_jax(bridged):
    """The loss, its xent and its balance term (summed over the layers,
    weighted 0.01) and every gradient against jax.value_and_grad, on a
    batch of 3 x 18 positions: 2 groups of 27 tokens at capacity 8, where
    assignments drop."""
    jmodel, state, model = bridged
    tokens = np.random.default_rng(6).integers(0, 256, (3, 19))
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)}),
        has_aux=True)(state["params"])
    model.zero_grad(set_to_none=True)
    with moe.record_routing() as log:
        loss, aux = model.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    assert len(log) == model.cfg.num_layers and sum(int((~r["valid"]).sum()) for r in log) > 0
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(aux["xent"].item(), float(jaux["xent"]), **TOL)
    np.testing.assert_allclose(aux["aux"].item(), float(jaux["aux"]), **TOL)
    assert aux["aux"].item() > 1.0        # num_experts * sum(frac * mean): 1 when balanced
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(port) == len(ref)
    for (path, got), (_, want) in zip(port, ref):
        assert np.isfinite(got).all(), tree.keystr(path)
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path), **TOL)
    model.zero_grad(set_to_none=True)


def test_opt_vector_and_npz_keys_are_the_references(bridged):
    """The MoE state flattens to JAX's .npz keys (the moe subtree, its
    shared MLP nested, in jax.tree_util's order) with JAX's shapes and
    dtypes, and its opt vector is the reference's bit for bit."""
    _, state, model = bridged
    params = param_tree(model)
    port_state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
                  "opt": adamw_init(params)}
    port, ref = storage._flatten(port_state), j_storage._flatten(state)
    assert list(port) == list(ref)
    assert "params|blocks|moe|router" in port and port["opt|m|blocks|moe|w_gate"].ndim == 4
    for key, arr in ref.items():
        assert port[key].shape == arr.shape and port[key].dtype == arr.dtype, key
    np.testing.assert_array_equal(_flatten_opt(port_state["opt"])[0],
                                  j_flatten_opt(state["opt"])[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_match_jax_tree(arch):
    """bf16 model: the tree, shapes and dtypes of the reference's, the
    router and shared_gate fp32."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    specs = jax.tree_util.tree_flatten_with_path(j_build_model(jcfg).param_specs())[0]
    ref = {tree.keystr(tuple(k.key for k in path)): s for path, s in specs}
    port = tree.tree_flatten_with_path(param_tree(build_model(tcfg, device="meta")))
    assert [tree.keystr(p) for p, _ in port] == list(ref)
    for path, leaf in port:
        spec = ref[tree.keystr(path)]
        assert tuple(leaf.shape) == tuple(spec.shape), path
        assert str(leaf.dtype).split(".")[-1] == str(spec.dtype), path
    assert ref["blocks|moe|router"].dtype == jnp.float32


# -------------------------------- config --------------------------------- #
@pytest.mark.parametrize("arch,total,active", [
    ("qwen2-moe-a2.7b", 15_146_829_824, 2_689_746_944),
    ("qwen3-moe-30b-a3b", 30_532_646_912, 3_353_556_992)])
def test_full_param_counts(arch, total, active):
    """Counted on the meta device at full width and depth, against the
    reference's param_count and active_param_count."""
    assert param_count(get_arch(arch)) == j_param_count(j_get_arch(arch)) == total
    assert active_param_count(get_arch(arch)) == j_active_param_count(j_get_arch(arch)) \
        == active


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_jax(arch, smoke):
    tcfg, jcfg = get_arch(arch), j_get_arch(arch)
    if smoke:
        tcfg, jcfg = reduce_for_smoke(tcfg), j_reduce(jcfg)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert (tcfg.padded_experts, tcfg.is_moe, tcfg.resolved_head_dim, tcfg.padded_vocab) == \
        (jcfg.padded_experts, jcfg.is_moe, jcfg.resolved_head_dim, jcfg.padded_vocab)
    assert tcfg.layer_kinds() == jcfg.layer_kinds()


# ------------------------------- training -------------------------------- #
FABRIC = dict(link_bw=50e9, dcn_bw=5e9)       # the reference's, passed to both
HP = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def test_five_cluster_steps_and_a_recovery_track_jax(tmp_path):
    """qwen2-moe smoke through both SimClusters from the same state: five
    steps' losses and the opt vector at 2e-4, then a software failure
    recovered bitwise from the neighbour and two more steps."""
    kw = dict(dp=4, global_batch=8, seq_len=16, full_every=50, seed=0)
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    j = JSimCluster(jcfg, cluster=JClusterConfig(hp=JAdamWConfig(**HP), ckpt_dir=tmp_path / "j",
                                                 **kw), fabric=JFabricConfig(**FABRIC))
    t = SimCluster(tcfg, cluster=ClusterConfig(hp=AdamWConfig(**HP), ckpt_dir=tmp_path / "t",
                                               **kw), fabric=FabricConfig(**FABRIC),
                   device="cpu")
    t.load_state(jax.tree.map(np.asarray, j.state))
    np.testing.assert_allclose(t.run(5), j.run(5), **TOL)
    np.testing.assert_allclose(_flatten_opt(t.state["opt"])[0],
                               j_flatten_opt(j.state["opt"])[0], **TOL)
    before = _flatten_opt(t.state["opt"])[0]
    t.inject_failure([2])
    rep = t.recover()
    assert rep.recovered_from == "neighbor" and rep.rolled_back_iterations == 0
    np.testing.assert_array_equal(_flatten_opt(t.state["opt"])[0], before)
    j.inject_failure([2])
    j.recover()
    np.testing.assert_allclose(t.run(2), j.run(2), **TOL)


def test_sharded_step_at_one_batch_rank_matches_jax():
    """build_train_step on a (1, 1) mesh, FSDP on, two steps of a batch
    that drops assignments: the losses and the new state (params, master,
    m, v) against the reference's build_train_step on a (1, 1) mesh."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    hp = dict(lr=1e-3, warmup_steps=0, total_steps=50)
    jmodel = j_build_model(jcfg)
    jstate = j_init_state(jmodel, jax.random.key(3))
    model = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), tcfg, device="cpu")
    mesh = make_single_device_mesh()
    art = build_train_step(model, mesh, AdamWConfig(**hp),
                           shape=ShapeConfig("t", 18, 3, "train"))
    state = shard_init_state(param_tree(model), art.plan, mesh)
    jmesh = make_mesh_compat((1, 1), ("data", "model"))
    jart = j_build_train_step(jmodel, jmesh, JAdamWConfig(**hp), donate=False,
                              shape=JShapeConfig("t", 18, 3, "train"))
    rng = np.random.default_rng(4)
    with jmesh:
        for _ in range(2):
            tokens = rng.integers(0, 256, (3, 19))
            jstate, jmetrics, _ = jart.step_fn(jstate, {"tokens": jnp.asarray(tokens, jnp.int32)})
            state, metrics, _ = art.step_fn(state, {"tokens": torch.from_numpy(tokens)})
            np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), **TOL)
            np.testing.assert_allclose(metrics["aux"].item(), float(jmetrics["aux"]), **TOL)
    joined = join_tree(state, art.plan.state_pspecs, mesh)
    port = {tree.keystr(p): t for p, t in tree.tree_flatten_with_path(joined)}
    ref = {"|".join(str(getattr(k, "key", k)) for k in p): v
           for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert sorted(port) == sorted(ref)
    for key, want in ref.items():
        np.testing.assert_allclose(_np(port[key]), np.asarray(want, np.float32),
                                   err_msg=key, **TOL)


# ------------------------------ entry points ----------------------------- #
def _run_cli(args):
    return subprocess.run(
        [sys.executable, "-m", *args], capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))


def test_serve_cli_on_the_smoke_moe():
    proc = _run_cli(["repro_torch.launch.serve", "--device", "cpu", "--smoke", "--arch",
                     "qwen2-moe-a2.7b", "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "prefill: 2x8" in proc.stdout and "decoded 5 tokens/seq" in proc.stdout


def test_train_cli_on_the_smoke_moe(tmp_path):
    proc = _run_cli(["repro_torch.launch.train", "--device", "cpu", "--smoke", "--arch",
                     "qwen2-moe-a2.7b", "--steps", "6", "--dp", "4", "--inject-failure", "3",
                     "--ckpt-dir", str(tmp_path / "ck")])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "recovered from neighbor (stream policy)" in proc.stdout
    assert "rollback=0" in proc.stdout and "done: 6 iterations" in proc.stdout


# --------------------------------- the card ------------------------------ #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_on_the_card_matches_the_cpu(arch):
    """The drop case, fp32: out, aux, every gradient and the routing (top_e,
    positions) on the card against the CPU."""
    _card()
    _, tcfg, p, x, gy = _moe_case(arch, "drops")
    cpu = _port_moe(tcfg, p, x, gy)
    card = _port_moe(tcfg, p, x, gy, device="cuda")
    for name in ("top_e", "pos", "valid"):
        assert torch.equal(card[4][0][name].cpu(), cpu[4][0][name]), name
    torch.testing.assert_close(card[0].cpu(), cpu[0], **TOL)
    torch.testing.assert_close(card[1].cpu(), cpu[1], **TOL)
    torch.testing.assert_close(card[3].grad.cpu(), cpu[3].grad, **TOL)
    for got, want in zip(jax.tree.leaves(card[2], is_leaf=torch.is_tensor),
                         jax.tree.leaves(cpu[2], is_leaf=torch.is_tensor)):
        torch.testing.assert_close(got.grad.cpu(), want.grad, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_on_the_card_matches_the_cpu(arch):
    """The smoke MoE model, fp32: prefill, a decode step and the loss with
    every gradient on the card (the fp32 flash and decode kernels) against
    the same weights on the CPU."""
    _card()
    _, tcfg = _cfgs(arch)
    cpu = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(tcfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 23)))
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        logits, cache = build_prefill_step(model)(tokens[:, :20].to(model.device), 24)
        logits2, _ = build_decode_step(model)(cache, tokens[:, 20].to(model.device))
        model.requires_grad_(True)
        loss, aux = model.loss({"tokens": tokens.to(model.device)})
        loss.backward()
        outs[name] = [logits.cpu(), logits2.cpu(), loss.detach().cpu(),
                      aux["aux"].detach().cpu()] + [p.grad.cpu() for p in model.parameters()]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, **TOL)

