"""The port's training pieces against the JAX package, at the smoke size
of qwen3-0.6b in fp32 on the CPU: the tree order and key paths, the chunked
cross-entropy and the gradient barrier, the flash kernel's autograd
function (plain route), ``DecoderLM.loss`` and its gradients, AdamW and the
schedule, and the flattened optimizer vector; and ``DecoderLM.loss`` in
bf16. Then SSM training: the SSD's autograd function (plain route) against
the gradient of the reference's ``ssd_chunked``, and ``MambaLM.loss`` with
every gradient at the smoke size of mamba2-2.7b. The same numpy inputs go
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
from repro.models import mamba2 as j_mamba2
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
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as tssd
from repro_torch.models import layers
from repro_torch.models.attention import repeat_kv
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime.recovery import _flatten_opt, _unflatten_opt
from repro_torch.train.state import grad_tree, param_tree

LOSS_TOL = dict(rtol=2e-4, atol=2e-4)    # the serving slice's fp32 tolerance
XENT_TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
# bf16: the tolerance of the reference's own bf16 kernel tests
# (tests/test_kernels.py::_tol), there on O(1) values, here taken relative to
# each gradient leaf's largest magnitude
BF16_TOL = 2e-2


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


def _bf16_grads(seq: int):
    """Loss and gradients of qwen3-0.6b at smoke size from the same
    bf16-valued weights: JAX in bf16, the port in bf16 and JAX in fp32 (the
    exact gradient of those weights, to within fp32)."""
    jcfg, tcfg = _cfgs()
    jb = j_build_model(dataclasses.replace(jcfg, dtype="bfloat16"))
    params = j_init_state(jb, jax.random.key(0))["params"]
    tokens = np.random.default_rng(5).integers(0, 256, (3, seq))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    out = {}
    for name, model, p in (
            ("jax", jb, params),
            ("fp32", j_build_model(jcfg), jax.tree.map(lambda a: a.astype(jnp.float32), params))):
        (jl, _), jg = jax.value_and_grad(lambda q: model.loss(q, batch), has_aux=True)(p)
        out[name] = (float(jl), [np.asarray(g, np.float32) for g in jax.tree.leaves(jg)])
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              dataclasses.replace(tcfg, dtype="bfloat16"), device="cpu")
    model.requires_grad_(True)
    loss, _ = model.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    flat = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    out["port"] = (loss.item(), [np.asarray(g, np.float32) for _, g in flat])
    return out, [tree.keystr(path) for path, _ in flat]


@pytest.mark.parametrize("seq", [17, 64])
def test_bf16_loss_and_every_gradient_match_jax(seq):
    """The bf16 training path against JAX's: the loss and all 13 gradients
    within the bf16 tolerance, and no drift: the port's gradients are no
    further from the fp32 gradient of the same weights than 1.5x the
    reference's own bf16 gradients are. (The port rounds the head's
    d_logits to bf16 before its products, JAX's CPU transpose keeps them
    fp32; this shows the rounding costs nothing measurable.)"""
    out, names = _bf16_grads(seq)
    (jl, jg), (pl, pg), (_, fg) = out["jax"], out["port"], out["fp32"]
    assert len(names) == len(jg) == len(fg) == 13
    np.testing.assert_allclose(pl, jl, rtol=BF16_TOL, atol=BF16_TOL)
    for name, got, want, exact in zip(names, pg, jg, fg):
        np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                                   atol=BF16_TOL * np.abs(want).max(), err_msg=name)
        err_port = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        err_jax = np.linalg.norm(want - exact) / np.linalg.norm(exact)
        assert err_port <= 1.5 * err_jax, (name, err_port, err_jax)


def test_loss_is_differentiable_only_once_trainable():
    _, tcfg = _cfgs()
    from repro_torch.models import build_model
    model = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = {"tokens": torch.zeros(1, 5, dtype=torch.long)}
    assert not model.loss(tokens)[0].requires_grad
    model.requires_grad_(True)
    assert model.loss(tokens)[0].requires_grad


# ------------------------------ SSM training ----------------------------- #
@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (21, 8)])
def test_ssd_function_grads_match_jax(s, chunk, initial):
    """``SSD`` (the CPU route) against jax.grad of the reference's
    ``ssd_chunked``: y, the final state and the gradients of x, dt, a, B, C
    and the initial state, for a cotangent on both outputs; a ragged last
    chunk included."""
    rng = np.random.default_rng(s + initial)
    b, h, p, n = 2, 3, 4, 8
    arrs = [rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.1, size=(b, s, h)),
            -rng.uniform(0.5, 2.0, size=(h,)), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, s, n)), rng.normal(size=(b, h, n, p))]
    arrs = [np.asarray(a, np.float32) for a in arrs]
    gy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    gf = rng.normal(size=(b, h, n, p)).astype(np.float32)
    n_in = 6 if initial else 5

    def jfn(*args):
        y, final = j_mamba2.ssd_chunked(*args[:5], chunk=chunk,
                                        initial_state=args[5] if initial else None)
        return jnp.sum(y * gy) + jnp.sum(final * gf), (y, final)

    (_, (jy, jfinal)), jgrads = jax.value_and_grad(jfn, argnums=tuple(range(n_in)),
                                                   has_aux=True)(*map(jnp.asarray, arrs[:n_in]))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrs[:n_in]]
    y, final = ops.ssd(*leaves[:5], chunk=chunk, initial_state=leaves[5] if initial else None)
    assert y.grad_fn is not None and final.grad_fn is not None
    torch.autograd.backward((y, final), (torch.from_numpy(gy), torch.from_numpy(gf)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **LOSS_TOL)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(jfinal), **LOSS_TOL)
    for name, t, want in zip(("x", "dt", "a", "b", "c", "initial_state"), leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), err_msg=name, **LOSS_TOL)


def test_ssd_gradient_stays_finite_where_the_in_chunk_decay_overflows():
    """A 256-position chunk whose decay passes fp32's range for j > i (a =
    -16, dt 0.05: the exponent reaches 205), as at full width. The
    reference's ``ssd_chunked`` masks after exp and its gradients of dt and a
    are NaN there; the port's masks the exponent first, and its gradients
    equal the reference's at a chunk of 16 (the same function, no
    overflow)."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 256, 2, 8, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 0.05, np.float32)
    a = np.array([-16.0, -1.0], np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))

    def jgrad(chunk):
        return jax.grad(lambda *t: j_mamba2.ssd_chunked(*t, bm, cm, chunk=chunk)[0].sum(),
                        argnums=(0, 1, 2))(x, dt, a)

    assert not np.isfinite(np.asarray(jgrad(256)[1])).all()      # the reference's NaN
    leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in (x, dt, a)]
    ops.ssd(*leaves, torch.from_numpy(bm), torch.from_numpy(cm), chunk=256)[0].sum().backward()
    for name, t, want in zip(("x", "dt", "a"), leaves, jgrad(16)):
        assert torch.isfinite(t.grad).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), err_msg=name,
                                   rtol=2e-4, atol=2e-4 * np.abs(want).max())


def test_ssd_function_with_an_unused_output_and_no_launch_on_the_cpu():
    """Only y is used (as in ``mamba_apply``): the final state's gradient
    arrives as None; inputs that need no gradient get none; nothing is
    counted as a kernel launch on the CPU."""
    before = (tssd.ssd.launches, dict(tssd.ssd.routes))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 10, 2, 4)).astype(np.float32)).requires_grad_()
    dt = torch.full((1, 10, 2), 0.05)
    a = torch.tensor([-1.0, -0.5], requires_grad=True)
    bm = torch.from_numpy(rng.normal(size=(1, 10, 8)).astype(np.float32))
    y, _ = tssd.SSD.apply(x, dt, a, bm, bm.clone(), 4, None)
    y.square().sum().backward()
    assert x.grad is not None and a.grad is not None and dt.grad is None
    want = torch.autograd.grad(
        tssd.SSD.apply(x, dt, a, bm, bm.clone(), 4, None)[0].square().sum(), x)[0]
    torch.testing.assert_close(x.grad, want)
    assert (tssd.ssd.launches, tssd.ssd.routes) == before


def _ssm_cfgs():
    jcfg = dataclasses.replace(j_reduce(j_get_arch("mamba2-2.7b")), dtype="float32")
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch("mamba2-2.7b")), dtype="float32")
    return jcfg, tcfg


@pytest.mark.parametrize("seq", [17, 40])
def test_ssm_loss_and_every_gradient_match_jax(seq):
    """``MambaLM.loss`` (the embedding as the head, through chunked_xent)
    and all 2 + 2 x 14 gradients against jax.value_and_grad of the
    reference's SSM loss; seq 40 spans five 8-position SSD chunks."""
    jcfg, tcfg = _ssm_cfgs()
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(2))
    tokens = np.random.default_rng(seq).integers(0, 256, (3, seq + 1))
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)}),
        has_aux=True)(params)
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    model.requires_grad_(True)
    loss, aux = model.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(aux["xent"].item(), float(jaux["xent"]), **LOSS_TOL)
    assert aux["aux"].item() == float(jaux["aux"]) == 0.0
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(port) == len(ref) == 2 + 14
    for (path, got), (_, want) in zip(port, ref):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path),
                                   **LOSS_TOL)
        assert np.abs(got).max() > 0, tree.keystr(path)


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
