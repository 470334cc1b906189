"""The port's training pieces against the JAX package, at the smoke size
of qwen3-0.6b in fp32 on the CPU: the tree order and key paths, the chunked
cross-entropy and the gradient barrier, the flash kernel's autograd
function (plain route), ``DecoderLM.loss`` and its gradients, AdamW and the
schedule, and the flattened optimizer vector. The same numpy inputs go
through both packages; tolerances are stated per test."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import storage as j_storage
from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.kernels import ops as j_ops
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.runtime.recovery import _flatten_opt as j_flatten_opt
from repro.train.state import init_state as j_init_state
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt import storage
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers
from repro_torch.models.attention import repeat_kv
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime.recovery import _flatten_opt, _unflatten_opt
from repro_torch.train.state import grad_tree, param_tree

LOSS_TOL = dict(rtol=2e-4, atol=2e-4)    # the serving slice's fp32 tolerance
XENT_TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _cfgs():
    jcfg = dataclasses.replace(j_reduce(j_get_arch("qwen3-0.6b")), dtype="float32")
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def bridged():
    """The JAX package's init_state at smoke size (fp32), its host copy,
    and the port's model holding the same parameters."""
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg)
    state = j_init_state(jmodel, jax.random.key(0))
    host = jax.tree.map(np.asarray, state)
    model = params_from_numpy(host["params"], tcfg, device="cpu")
    model.requires_grad_(True)
    return jmodel, state, host, model


def _port_state(model):
    params = param_tree(model)
    return {"step": torch.zeros((), dtype=torch.int32), "params": params,
            "opt": adamw_init(params)}


# ------------------------------ tree order ------------------------------- #
def test_tree_order_matches_jax_on_a_mixed_tree():
    t = {"b": [np.ones(2), None, (np.zeros(1), np.ones(3))], "a": {"z": np.ones(1), "c": 2.0},
         "m": None}
    jpaths, jleaves = zip(*jax.tree_util.tree_flatten_with_path(t)[0])
    paths = [tree.keystr(p) for p, _ in tree.tree_flatten_with_path(t)]
    assert paths == [tree.keystr(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p))
                     for p in jpaths]
    leaves, treedef = tree.tree_flatten(t)
    assert all(a is b for a, b in zip(leaves, jleaves))
    assert tree.tree_unflatten(treedef, leaves)["b"][2][1] is t["b"][2][1]


def test_state_tree_keys_and_leaves_match_jax(bridged):
    """The port's state, layers held one module each, flattens to the
    reference's key paths (``storage._flatten``, the .npz keys) and leaves."""
    _, state, host, model = bridged
    port = storage._flatten(_port_state(model))
    ref = j_storage._flatten(state)
    assert list(port) == list(ref)
    for key, arr in ref.items():
        assert port[key].shape == arr.shape and port[key].dtype == arr.dtype, key
        if key.startswith(("params", "opt|master")):
            np.testing.assert_array_equal(port[key], np.asarray(arr), err_msg=key)


def test_bf16_leaves_go_to_the_host_bit_for_bit():
    t = torch.randn(3, 5).to(torch.bfloat16)
    stacked = tree.Stacked([t, t + 1])
    host = tree.to_numpy(stacked)
    assert host.shape == (2, 3, 5) and host.dtype.itemsize == 2
    back = torch.zeros(2, 3, 5, dtype=torch.bfloat16)
    tree.copy_from_numpy_(tree.Stacked(list(back)), host)
    assert torch.equal(back[0], t) and torch.equal(back[1], t + 1)


# --------------------------- xent and barrier ---------------------------- #
@pytest.mark.parametrize("b,s,chunk", [(2, 16, 8), (2, 13, 5), (1, 7, 512)])
def test_chunked_xent_value_and_grads_match_jax(b, s, chunk):
    rng = np.random.default_rng(s)
    v, d = 96, 32
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(v, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (b, s))
    jfn = lambda x_, w_: j_layers.chunked_xent({"w": w_}, x_, jnp.asarray(labels), chunk=chunk)
    jval, (jdx, jdw) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, w))
    val = layers.chunked_xent(wt, xt, torch.from_numpy(labels), chunk=chunk)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), **XENT_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **XENT_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **XENT_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_grad_barrier_casts_the_cotangent(dtype):
    x = torch.randn(4, 3).to(dtype).requires_grad_()
    y = layers.bf16_grad_barrier(x)
    assert torch.equal(y, x)
    (y.float() * 3.0).sum().backward()
    assert x.grad.dtype == dtype
    assert torch.equal(x.grad.float(), torch.full((4, 3), 3.0))
    # an fp32 cotangent comes out in the input's dtype
    g = torch.full((4, 3), 1.0 + 2.0 ** -12)
    out = layers._GradBarrier.backward(types.SimpleNamespace(dtype=dtype), g)
    assert out.dtype == dtype and torch.equal(out, g.to(dtype))


# ------------------------------- attention ------------------------------- #
@pytest.mark.parametrize("h,kh", [(2, 2), (4, 2)])
def test_flash_autograd_function_matches_jax_custom_vjp(h, kh):
    """FlashAttention on CPU tensors (the plain forward, the blockwise
    recompute in the backward) against the JAX kernel's custom VJP in
    interpret mode, value and gradients at 1e-4, as
    tests/test_kernels.py::test_flash_attention_grad holds it."""
    rng = np.random.default_rng(h)
    b, s, hd = 1, 128, 64
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    g = rng.normal(size=(b, s, h, hd)).astype(np.float32)

    def jfn(q_, k_, v_):
        rep = lambda t: jnp.repeat(t, h // kh, axis=2)
        return j_ops.flash_attention(q_, rep(k_), rep(v_), causal=True, bq=64, bk=64)

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v))
    out = fa.FlashAttention.apply(qt, kt, vt, True)
    out.backward(torch.from_numpy(g))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    for got, want in zip((qt.grad, kt.grad, vt.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_flash_function_counts_no_launch_on_the_cpu():
    before = fa.flash_attention.launches
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    fa.FlashAttention.apply(q, k, k, True).sum().backward()
    assert fa.flash_attention.launches == before and q.grad is not None


# --------------------------------- model --------------------------------- #
def test_loss_and_every_gradient_match_jax(bridged):
    jmodel, state, host, model = bridged
    tokens = np.random.default_rng(5).integers(0, 256, (3, 17))
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)}),
        has_aux=True)(state["params"])
    model.zero_grad(set_to_none=True)
    loss, aux = model.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(aux["xent"].item(), float(jaux["xent"]), **LOSS_TOL)
    assert aux["aux"].item() == float(jaux["aux"]) == 0.0
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(port) == len(ref) == 13
    for (path, got), (_, want) in zip(port, ref):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path),
                                   **LOSS_TOL)
    model.zero_grad(set_to_none=True)


def test_loss_is_differentiable_only_once_trainable():
    _, tcfg = _cfgs()
    from repro_torch.models import build_model
    model = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = {"tokens": torch.zeros(1, 5, dtype=torch.long)}
    assert not model.loss(tokens)[0].requires_grad
    model.requires_grad_(True)
    assert model.loss(tokens)[0].requires_grad


# ------------------------------ optimizer -------------------------------- #
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["clip_inactive", "clip_active"])
def test_adamw_update_matches_jax(grad_scale):
    rng = np.random.default_rng(7)
    shapes = {"embed": {"w": (6, 4)}, "blocks": {"attn": {"wq": (2, 4, 4)}, "ln1": (2, 4)},
              "final_norm": (4,)}
    mk = lambda: jax.tree.map(lambda sh: rng.normal(size=sh).astype(np.float32), shapes,
                              is_leaf=lambda x: isinstance(x, tuple))
    params, grads = mk(), jax.tree.map(lambda a: a * grad_scale, mk())
    m, v = mk(), jax.tree.map(np.abs, mk())
    hp = JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step, lr = 4, 7e-4
    j_opt = {"master": jax.tree.map(jnp.asarray, params), "m": jax.tree.map(jnp.asarray, m),
             "v": jax.tree.map(jnp.asarray, v)}
    _, j_new = j_adamw_update(jax.tree.map(jnp.asarray, grads), j_opt,
                              jnp.asarray(step, jnp.int32), hp, jnp.asarray(lr, jnp.float32))
    as_t = lambda t_: tree.tree_map(lambda a: torch.from_numpy(a.copy()), t_)
    opt = {"master": as_t(params), "m": as_t(m), "v": as_t(v)}
    master, new = adamw_update(as_t(grads), opt, torch.tensor(step, dtype=torch.int32),
                               AdamWConfig(**dataclasses.asdict(hp)), torch.tensor(lr))
    assert new is opt and master is opt["master"]            # in place
    for key in ("master", "m", "v"):
        for got, want in zip(tree.tree_leaves(new[key]), jax.tree.leaves(j_new[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPT_TOL)


@pytest.mark.parametrize("step", [0, 1, 3, 10, 57, 100, 140])
def test_cosine_schedule_matches_jax(step):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=100)
    want = float(j_cosine_schedule(jnp.asarray(step, jnp.int32), **kw))
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw).item()
    np.testing.assert_allclose(got, want, **OPT_TOL)


def test_flattened_opt_vector_is_the_references_bit_for_bit(bridged):
    _, state, host, model = bridged
    opt = _port_state(model)["opt"]
    tree.copy_from_numpy_(opt, host["opt"])
    vec, meta = _flatten_opt(opt)
    ref, _ = j_flatten_opt(state["opt"])
    assert vec.dtype == np.float32 and vec.shape == ref.shape
    np.testing.assert_array_equal(vec, ref)
    back = _unflatten_opt(vec, meta)
    for (p, a), (q, b) in zip(tree.tree_flatten_with_path(back),
                              jax.tree_util.tree_flatten_with_path(host["opt"])[0]):
        np.testing.assert_array_equal(a, b)


# --------------------------------- card ---------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_grads_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ((2, 130, 4, 64), (2, 130, 2, 64), (2, 130, 2, 64))
    qkv = [torch.randn(sh, generator=gen, device="cuda").to(dtype) for sh in shapes]
    g = torch.randn(shapes[0], generator=gen, device="cuda").to(dtype)
    outs = []
    for fn in (lambda *a: fa.FlashAttention.apply(*a, True),
               lambda q, k, v: layers_plain(q, k, v)):
        leaves = [t.clone().requires_grad_() for t in qkv]
        out = fn(*leaves)
        out.backward(g)
        outs.append([out.detach()] + [t.grad for t in leaves])
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(*outs):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def layers_plain(q, k, v):
    from repro_torch.models.attention import blockwise_attention
    h = q.shape[2]
    return blockwise_attention(q, repeat_kv(k, h), repeat_kv(v, h), causal=True)
