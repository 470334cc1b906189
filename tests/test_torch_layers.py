"""The port's layers against ``repro.models.layers``: the same numpy inputs
through the JAX function and its PyTorch counterpart, fp32 at 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(arr, dtype=np.float32):
    arr = np.asarray(arr, dtype)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


@pytest.mark.parametrize("fn", ["rms_norm", "head_rms_norm"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 4, 16)])
def test_norms_match_reference(fn, shape):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=shape) * 3.0)
    sj, st = _pair(rng.normal(size=shape[-1:]) * 0.1)
    ref = getattr(jl, fn)(xj, sj)
    out = getattr(tl, fn)(xt, st)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_rope_frequencies_identical():
    for hd, theta in ((16, 1e4), (128, 1e6)):
        np.testing.assert_array_equal(tl.rope_frequencies(hd, theta),
                                      jl.rope_frequencies(hd, theta))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("hd", [16, 128])
def test_apply_rope_at_arbitrary_positions(theta, hd):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(size=(2, 7, 4, hd)))
    pos = rng.integers(0, 5000, size=(2, 7))
    ref = jl.apply_rope(xj, jnp.asarray(pos, jnp.int32), theta)
    out = tl.apply_rope(xt, torch.from_numpy(pos), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "sq_relu", "gelu"])
def test_mlp_apply_each_flavour(mlp_type):
    rng = np.random.default_rng(3)
    d, f = 32, 48
    names = {"w_up": (d, f), "w_down": (f, d)}
    if mlp_type in ("swiglu", "geglu"):
        names["w_gate"] = (d, f)
    pj, pt = {}, {}
    for name, shape in names.items():
        pj[name], pt[name] = _pair(rng.normal(size=shape) / np.sqrt(shape[0]))
    xj, xt = _pair(rng.normal(size=(2, 5, d)))
    ref = jl.mlp_apply(pj, xj, mlp_type)
    out = tl.mlp_apply(pt, xt, mlp_type)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_mlp_apply_rejects_unknown_flavour():
    with pytest.raises(ValueError):
        tl.mlp_apply({}, torch.zeros(1, 2), "relu6")


def test_embed_lookup():
    rng = np.random.default_rng(4)
    wj, wt = _pair(rng.normal(size=(50, 16)))
    toks = rng.integers(0, 50, size=(3, 6))
    ref = jl.embed_lookup({"w": wj}, jnp.asarray(toks))
    out = tl.embed_lookup(wt, torch.from_numpy(toks))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(4,), (2, 3)])
def test_unembed_fp32_logits(dtype, lead):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 32)) * 0.02
    x = rng.normal(size=lead + (32,))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    ref = jl.unembed({"w": jnp.asarray(w, jdt)}, jnp.asarray(x, jdt))
    out = tl.unembed(torch.from_numpy(w).to(tdt), torch.from_numpy(x).to(tdt))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_embed_init_distribution():
    g = torch.Generator().manual_seed(0)
    w = tl.embed_init(g, 512, 64, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (512, 64)
    assert abs(w.float().std().item() - 0.02) < 1e-3
