"""qwen3-moe-30b-a3b's routing and attention shapes against the JAX package
on the CPU: the smoke config (``reduce_for_smoke`` of both packages, which
cuts an MoE to 8 experts and top-2) given back the full config's 128 experts,
top-8 and 32 q heads on 4 kv heads (group 8), 2 layers. ``moe_apply`` (out,
the balance loss, dx, every gradient, the top-8 experts and their capacity
positions exactly) where assignments drop, dropless, with exact gate ties
and on unshifted routing; the model's forward, prefill with 8 decode steps
and their caches, the loss and every gradient. Parameters are the
reference's, moved across with ``params_from_numpy``; inputs are made from
numpy seeds. fp32 at 2e-4 (the reference's test_prefill_decode_matches_forward).
Both attention kernels at the full model's serve shapes are held on the
card by tests/test_torch_cuda.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.train.state import init_state as j_init_state
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models import moe
from repro_torch.train.serve import build_decode_step, build_prefill_step
from repro_torch.train.state import grad_tree
from test_torch_moe import _assert_grads, _jax_moe, _np, _port_moe, _reference_routing

ARCH = "qwen3-moe-30b-a3b"
TOL = dict(rtol=2e-4, atol=2e-4)
# the full config's routing and attention heads on the smoke widths
FULL = dict(num_experts=128, top_k=8, num_heads=32, num_kv_heads=4, num_layers=2)
B, S, STEPS = 2, 11, 8
MAX_LEN = S + STEPS + 1
HOT = 5                      # the expert a shifted router makes hot


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(j_reduce(j_get_arch(ARCH)), dtype=dtype, **FULL, **kw)
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch(ARCH)), dtype=dtype, **FULL, **kw)
    return jcfg, tcfg


def test_the_config_is_the_full_routing_on_smoke_widths():
    """Both packages' configs agree field by field: 128 experts (none
    padded), top-8, group 8 at head_dim 16, 2 layers, no shared expert."""
    jcfg, tcfg = _cfgs()
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert (tcfg.padded_experts, tcfg.top_k, tcfg.num_heads // tcfg.num_kv_heads,
            tcfg.num_shared_experts, tcfg.d_model) == (128, 8, 8, 0, 64)
    # reduce_for_smoke itself still cuts an MoE to 8 experts and top-2
    smoke = reduce_for_smoke(get_arch(ARCH))
    assert (smoke.num_experts, smoke.top_k) == (8, 2)


# ------------------------------ moe_apply -------------------------------- #
# (input shape, capacity_factor, router shifted toward HOT): "drops": 2 x 128
# tokens in 16 groups of 16 at capacity 8, every token picks HOT and each
# group drops 8 of its 16 assignments to it; "dropless": the same at
# capacity_factor 16 (capacity 16, an expert's most in a group of 16);
# "natural": 2 x 512 tokens, 16 groups of 64 at capacity 8, the router
# unshifted: 512 assignments a group over 128 experts, where the busiest
# experts overflow
CASES = {"drops": ((2, 128, 64), None, True),
         "dropless": ((2, 128, 64), 16.0, True),
         "natural": ((2, 512, 64), None, False)}


def _moe_case(case, tie=False):
    shape, cf, shifted = CASES[case]
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg = _cfgs(**kw)
    p = jax.tree.map(lambda a: np.array(a), j_moe.moe_init(jax.random.key(7), jcfg, jnp.float32))
    if shifted:
        p["router"][:, HOT] += 0.3
    if tie:                  # equal router columns: exact ties in every token's gates
        for a, b in ((HOT, HOT + 1), (20, 100), (3, 127)):
            p["router"][:, b] = p["router"][:, a]
    rng = np.random.default_rng(13)
    x = (rng.normal(size=shape) + (0.5 if shifted else 0.0)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    return jcfg, tcfg, p, x, gy


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_top8_of_128_matches_jax(case):
    """out, the balance loss, dx and every leaf's gradient against jax.grad
    of the reference's moe_apply; the top-8 experts and each assignment's
    capacity position equal the reference's routing lines; the drops are
    the ones asserted."""
    jcfg, tcfg, p, x, gy = _moe_case(case)
    jout, jaux, jgp, jgx = _jax_moe(jcfg, p, x, gy)
    out, aux, tp, tx, log = _port_moe(tcfg, p, x, gy)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    np.testing.assert_allclose(_np(tx.grad), _np(jgx), **TOL)
    _assert_grads(tp, jgp, TOL["rtol"], per_leaf_scale=False)

    top_e, pos = _reference_routing(jcfg, p, x)
    rec = log[0]
    assert rec["top_e"].shape == (16, x.shape[0] * x.shape[1] // 16, 8)
    np.testing.assert_array_equal(rec["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(rec["pos"].numpy(), pos)
    np.testing.assert_array_equal(rec["valid"].numpy(), pos < rec["capacity"])
    dropped = int((~rec["valid"]).sum())
    if case == "dropless":
        assert (rec["capacity"], dropped) == (16, 0)
    else:
        assert rec["capacity"] == 8
        assert dropped >= (16 * 8 if case == "drops" else 1)
    assert len(np.unique(top_e)) > 64          # the routing reaches most of the 128


@pytest.mark.parametrize("case", ["drops", "natural"])
def test_reference_drops_what_the_port_drops(case):
    """The reference's own output changes when its capacity is lifted: the
    drops are real in both packages."""
    jcfg, tcfg, p, x, gy = _moe_case(case)
    jout = np.asarray(j_moe.moe_apply(p, jcfg, jnp.asarray(x))[0])
    lifted = dataclasses.replace(jcfg, capacity_factor=64.0)
    jout_dropless = np.asarray(j_moe.moe_apply(p, lifted, jnp.asarray(x))[0])
    assert np.abs(jout - jout_dropless).max() > 1e-3
    out, *_ = _port_moe(dataclasses.replace(tcfg, capacity_factor=64.0), p, x, gy)
    np.testing.assert_allclose(_np(out), jout_dropless, **TOL)


def test_tied_gates_inside_the_top8_route_as_jax():
    """Three pairs of experts with equal router columns tie exactly in every
    token's gate probabilities: the port orders them as ``lax.top_k`` does
    (the lower expert first), so top_e, the positions, out and the balance
    loss equal the reference's."""
    jcfg, tcfg, p, x, gy = _moe_case("natural", tie=True)
    top_e, pos = _reference_routing(jcfg, p, x)
    both = [((top_e == a).any(-1) & (top_e == b).any(-1)).sum()
            for a, b in ((HOT, HOT + 1), (20, 100), (3, 127))]
    assert sum(both) > 0                       # a tie inside some token's top-8
    jout, jaux, _, _ = _jax_moe(jcfg, p, x, gy)
    out, aux, _, _, log = _port_moe(tcfg, p, x, gy)
    np.testing.assert_array_equal(log[0]["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(log[0]["pos"].numpy(), pos)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


# ------------------------------- the model ------------------------------- #
def _pair(**kw):
    jcfg, tcfg = _cfgs(**kw)
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jmodel, params, model


def test_forward_matches_jax():
    jmodel, params, model = _pair()
    tokens = np.random.default_rng(2).integers(0, 256, (B, 2 * S))
    want = np.asarray(jmodel.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)}))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (B, 2 * S, 256)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("capacity", ["default", "dropless"])
def test_prefill_and_decode_match_jax(capacity):
    """Prefill, the KV cache after it, 8 greedy decode steps (tokens chosen
    by JAX) and the cache after them; at the default capacity (2 x 11
    tokens route as 2 groups of 11 at capacity 8) and dropless
    (capacity_factor 16)."""
    jmodel, params, model = _pair(**({"capacity_factor": 16.0} if capacity == "dropless"
                                     else {}))
    tokens = np.random.default_rng(3).integers(0, 256, (B, S))
    jlogits, jcache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t, "max_len": MAX_LEN}))(
        params, jnp.asarray(tokens, jnp.int32))
    logits, cache = build_prefill_step(model)(torch.from_numpy(tokens), MAX_LEN)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    for name in ("k", "v"):
        assert cache[name].shape == (2, B, MAX_LEN, 4, 16)
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), err_msg=name, **TOL)
    jdecode, decode = jax.jit(jmodel.decode_step), build_decode_step(model)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for step in range(STEPS):
        jlogits, jcache = jdecode(params, jcache, tok)
        logits, cache = decode(cache, torch.tensor(np.asarray(tok), dtype=torch.long))
        np.testing.assert_allclose(_np(logits), _np(jlogits), err_msg=f"step {step}", **TOL)
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    assert cache["index"] == S + STEPS
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), err_msg=name, **TOL)


def test_loss_and_every_gradient_match_jax():
    """The loss, its xent and balance term and every gradient against
    jax.value_and_grad, on 3 x 18 positions: 2 groups of 27 tokens at
    capacity 8, where assignments drop."""
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg)
    state = j_init_state(jmodel, jax.random.key(1))
    model = params_from_numpy(jax.tree.map(np.asarray, state["params"]), tcfg, device="cpu")
    model.requires_grad_(True)
    tokens = np.random.default_rng(6).integers(0, 256, (3, 19))
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)}),
        has_aux=True)(state["params"])
    with moe.record_routing() as log:
        loss, aux = model.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    assert len(log) == 2 and log[0]["top_e"].shape[-1] == 8
    assert sum(int((~r["valid"]).sum()) for r in log) > 0
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(aux["xent"].item(), float(jaux["xent"]), **TOL)
    np.testing.assert_allclose(aux["aux"].item(), float(jaux["aux"]), **TOL)
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(port) == len(ref)
    for (path, got), (_, want) in zip(port, ref):
        assert np.isfinite(got).all(), tree.keystr(path)
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path), **TOL)
