"""The port's Mamba2 slice against the JAX package on the CPU: the same numpy
inputs (and the same reference parameters, moved across with
``params_from_numpy``) through ``repro.models.mamba2`` / the SSM LM and
their counterparts in ``repro_torch``.

Tolerances: fp32 at 1e-5 for single ops (conv, one SSD step), 2e-5 for the
chunked SSD (the tolerance of tests/test_kernels.py), 1e-4 against the
token-by-token recurrence (as the reference's own test), 1e-3 on chunk
states (as tests/test_kernels.py), 2e-4 for blocks and whole models (the
reference's test_prefill_decode_matches_forward), 2e-2 in bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.kernels import ops as j_ops
from repro.kernels import ssd as j_ssd
from repro.kernels.ref import ssd_recurrent_ref as j_ssd_recurrent_ref
from repro.models import build_model as j_build_model
from repro.models import mamba2 as jm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as tssd
from repro_torch.models import build_model, mamba2 as tm, param_count
from repro_torch.models.transformer import MambaLM
from repro_torch.train.serve import build_decode_step, build_prefill_step

OP_TOL = dict(rtol=1e-5, atol=1e-5)
SSD_TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _pair(arr, dtype=np.float32):
    arr = np.asarray(arr, dtype)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def _ssd_inputs(seed, b, s, h, p, n):
    """x, dt (post-softplus), a (< 0), B, C as numpy fp32, the reference
    tests' distributions."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.1, size=(b, s, h)),
            -rng.uniform(0.5, 2.0, size=(h,)), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, s, n)))


def _as(arrs, jdtype, tdtype):
    """(jax arrays, torch tensors): x, B, C in the given dtype, dt and a fp32."""
    j, t = [], []
    for i, arr in enumerate(arrs):
        low = i not in (1, 2)
        jarr = jnp.asarray(np.asarray(arr, np.float32), jdtype if low else jnp.float32)
        j.append(jarr)
        t.append(torch.from_numpy(np.array(jarr.astype(jnp.float32))).to(
            tdtype if low else torch.float32))
    return j, t


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# --------------------------------------------------------------------------- #
# Ops
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv_matches_jax(s):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, s, 24)))
    wj, wt = _pair(rng.normal(size=(24, 4)) / 2)
    np.testing.assert_allclose(tm.causal_conv(xt, wt).numpy(),
                               np.asarray(jm.causal_conv(xj, wj)), **OP_TOL)


def test_causal_conv_step_matches_jax():
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(3, 1, 24)))
    wj, wt = _pair(rng.normal(size=(24, 4)) / 2)
    sj, st = _pair(rng.normal(size=(3, 3, 24)))
    yj, nj = jm.causal_conv_step(xj, wj, sj)
    yt, nt = tm.causal_conv_step(xt, wt, st)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **OP_TOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (7, 16)])
def test_ssd_chunked_matches_jax(s, chunk, initial):
    """Dividing, ragged last chunk, and S < chunk; with and without a
    carried-in state."""
    arrs = _ssd_inputs(2, 2, s, 4, 16, 32)
    (xj, dtj, aj, bj, cj), (xt, dtt, at, bt, ct) = _as(arrs, jnp.float32, torch.float32)
    init = np.random.default_rng(3).normal(size=(2, 4, 32, 16)) if initial else None
    ij, it = _pair(init) if initial else (None, None)
    yj, sj = jm.ssd_chunked(xj, dtj, aj, bj, cj, chunk=chunk, initial_state=ij)
    yt, st = tm.ssd_chunked(xt, dtt, at, bt, ct, chunk=chunk, initial_state=it)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **SSD_TOL)


def test_ssd_chunked_matches_recurrence():
    """Against the O(S) recurrence, both the port's and the reference's."""
    arrs = _ssd_inputs(4, 2, 96, 4, 16, 32)
    (xj, dtj, aj, bj, cj), (xt, dtt, at, bt, ct) = _as(arrs, jnp.float32, torch.float32)
    yt, st = tm.ssd_chunked(xt, dtt, at, bt, ct, chunk=32)
    yr, sr = ref.ssd_recurrent_ref(xt, dtt, at, bt, ct)
    yjr, sjr = j_ssd_recurrent_ref(xj, dtj, aj, bj, cj)
    for out, want in ((yt, yr), (st, sr), (yr, yjr), (sr, sjr)):
        np.testing.assert_allclose(_np(out), _np(want), rtol=1e-4, atol=1e-4)


def test_ssd_step_matches_jax():
    arrs = _ssd_inputs(5, 3, 1, 4, 16, 32)
    x, dt, a, bm, cm = (np.asarray(v, np.float32) for v in arrs)
    state = np.random.default_rng(6).normal(size=(3, 4, 32, 16)).astype(np.float32)
    yj, sj = jm.ssd_step(x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], state)
    st = torch.from_numpy(state.copy())
    yt, st2 = tm.ssd_step(*(torch.from_numpy(v) for v in
                            (x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])), st)
    assert st2 is st                                   # updated in place
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **OP_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **OP_TOL)


# --------------------------------------------------------------------------- #
# The SSD kernel's function and the code around it
# --------------------------------------------------------------------------- #
SWEEP = [(2, 64, 8, 16, 32, 16), (1, 128, 8, 32, 64, 32), (2, 48, 16, 16, 16, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
def test_ops_ssd_matches_pallas_kernel(b, s, h, p, n, chunk, dtype):
    """The port's ``ops.ssd`` (on the CPU: ssd_chunked) against
    ``repro.kernels.ops.ssd`` (the Pallas kernel, interpreted), at the sweep
    shapes of tests/test_kernels.py."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    (xj, dtj, aj, bj, cj), (xt, dtt, at, bt, ct) = _as(_ssd_inputs(7, b, s, h, p, n), jdt, tdt)
    yj, sj = j_ops.ssd(xj, dtj, aj, bj, cj, chunk=chunk, head_tile=4)
    yt, st = ops.ssd(xt, dtt, at, bt, ct, chunk=chunk)
    assert yt.dtype == tdt and st.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), _np(yj), **(SSD_TOL if dtype == "float32" else BF16_TOL))
    np.testing.assert_allclose(st.numpy(), _np(sj), **STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
def test_intra_chunk_plain_matches_pallas_kernel(b, s, h, p, n, chunk):
    """``ref.ssd_intra_chunk_ref`` (what the CUDA kernel is held to on the
    card) against the Pallas kernel's three outputs."""
    (xj, dtj, aj, bj, cj), (xt, dtt, at, bt, ct) = _as(
        _ssd_inputs(8, b, s, h, p, n), jnp.float32, torch.float32)
    want = j_ssd.ssd_intra_chunk(xj, dtj, aj, bj, cj, chunk=chunk, head_tile=4)
    got = ref.ssd_intra_chunk_ref(xt, dtt, at, bt, ct, chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **SSD_TOL)


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (7, 16), (600, 256)])
def test_kernel_wrapper_combine_matches_ssd_chunked(monkeypatch, s, chunk, initial):
    """``kernels.ssd.ssd`` (intra-chunk kernel + plain inter-chunk combine)
    with the kernel's launch replaced by its plain version, so that the
    Python around the kernel (ragged chunks, the scan over chunk states,
    y_inter, the carried-in state) runs on the CPU."""
    monkeypatch.setattr(tssd, "ssd_intra_chunk", ref.ssd_intra_chunk_ref)
    h, p, n = (4, 16, 32) if s < 600 else (2, 16, 16)
    _, (xt, dtt, at, bt, ct) = _as(_ssd_inputs(9, 2, s, h, p, n), jnp.float32, torch.float32)
    init = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, h, n, p)).astype(np.float32)) if initial else None
    y, st = tssd.ssd(xt, dtt, at, bt, ct, chunk=chunk, initial_state=init)
    yr, sr = tm.ssd_chunked(xt, dtt, at, bt, ct, chunk=chunk, initial_state=init)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), sr.numpy(), **SSD_TOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the card the wrapper launches the kernel or raises; it never runs
    the plain version itself (ops.ssd picks the plain version for CPU
    tensors)."""
    _, args = _as(_ssd_inputs(11, 1, 16, 2, 16, 16), jnp.float32, torch.float32)
    before = tssd.ssd_intra_chunk.launches
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_intra_chunk(*args, chunk=8)
    assert tssd.ssd_intra_chunk.launches == before


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _block_pair(cfg_j, seed):
    pj = jm.mamba_init(jax.random.key(seed), cfg_j, jnp.float32)
    pt = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in pj.items()}
    return pj, pt


@pytest.fixture(scope="module")
def smoke_cfgs():
    jcfg = dataclasses.replace(j_reduce(j_get_arch("mamba2-2.7b")), dtype="float32")
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch("mamba2-2.7b")), dtype="float32")
    return jcfg, tcfg


@pytest.mark.parametrize("s", [2, 13])
def test_mamba_prefill_and_decode_block_match_jax(smoke_cfgs, s):
    """One block: prefill over S tokens (S < k-1 pads the conv windows),
    then one decode step from its state."""
    jcfg, tcfg = smoke_cfgs
    pj, pt = _block_pair(jcfg, 0)
    rng = np.random.default_rng(12)
    xj, xt = _pair(rng.normal(size=(2, s, jcfg.d_model)))
    oj, stj = jm.mamba_prefill(pj, jcfg, xj)
    ot, stt = tm.mamba_prefill(pt, tcfg, xt)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MODEL_TOL)
    assert set(stt) == set(stj)
    for name in stj:
        assert stt[name].shape == stj[name].shape and stt[name].dtype == torch.float32
        np.testing.assert_allclose(stt[name].numpy(), np.asarray(stj[name]), **MODEL_TOL)
    np.testing.assert_allclose(tm.mamba_apply(pt, tcfg, xt).numpy(), ot.numpy(), **OP_TOL)

    dj, dt_ = _pair(rng.normal(size=(2, 1, jcfg.d_model)))
    odj, sdj = jm.mamba_decode(pj, jcfg, dj, stj)
    odt, sdt = tm.mamba_decode(pt, tcfg, dt_, {k: v.clone() for k, v in stt.items()})
    np.testing.assert_allclose(odt.numpy(), np.asarray(odj), **MODEL_TOL)
    for name in sdj:
        np.testing.assert_allclose(sdt[name].numpy(), np.asarray(sdj[name]), **MODEL_TOL)


def test_full_width_block_matches_jax():
    """One mamba2-2.7b block at full width (d 2560, 80 heads of P 64, N 128,
    chunk 256), fp32, S = 300: two chunks, the second ragged."""
    jcfg = dataclasses.replace(j_get_arch("mamba2-2.7b"), dtype="float32")
    tcfg = dataclasses.replace(get_arch("mamba2-2.7b"), dtype="float32")
    assert (tcfg.ssm_heads, tcfg.ssm_inner) == (jcfg.ssm_heads, jcfg.ssm_inner) == (80, 5120)
    pj, pt = _block_pair(jcfg, 1)
    xj, xt = _pair(np.random.default_rng(13).normal(size=(1, 300, 2560)))
    oj, stj = jax.jit(lambda p, x: jm.mamba_prefill(p, jcfg, x))(pj, xj)
    ot, stt = tm.mamba_prefill(pt, tcfg, xt)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **MODEL_TOL)
    np.testing.assert_allclose(stt["ssm"].numpy(), np.asarray(stj["ssm"]), **MODEL_TOL)


# --------------------------------------------------------------------------- #
# The SSM LM
# --------------------------------------------------------------------------- #
B, S, STEPS = 2, 12, 4


def _run_pair(dtype: str):
    """JAX and port runs of prefill + STEPS greedy decode steps (tokens
    chosen by JAX), from one parameter tree, at the smoke size."""
    jcfg = dataclasses.replace(j_reduce(j_get_arch("mamba2-2.7b")), dtype=dtype)
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch("mamba2-2.7b")), dtype=dtype)
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tokens = np.random.default_rng(14).integers(0, jcfg.vocab_size, (B, S))
    jlogits, jcache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}))(
        params, jnp.asarray(tokens, jnp.int32))
    jdecode = jax.jit(jmodel.decode_step)
    ref_run = {"prefill": _np(jlogits),
               "cache": {k: _np(v) for k, v in jcache["mamba"].items()},
               "index": int(jcache["index"]), "decode": [], "tokens": [], "states": []}
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        ref_run["tokens"].append(np.asarray(tok))
        jlogits, jcache = jdecode(params, jcache, tok)
        ref_run["decode"].append(_np(jlogits))
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ref_run["final"] = {k: _np(v) for k, v in jcache["mamba"].items()}

    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    logits, cache = prefill(torch.from_numpy(tokens), S + STEPS)
    port = {"prefill": _np(logits), "index": cache["index"],
            # copies: decode goes on to update the cache in place
            "cache": {k: _np(v).copy() for k, v in cache["mamba"].items()},
            "decode": []}
    for step in range(STEPS):
        logits, cache = decode(cache, torch.tensor(ref_run["tokens"][step], dtype=torch.long))
        port["decode"].append(_np(logits))
    port["final"] = {k: _np(v) for k, v in cache["mamba"].items()}
    port["index_after"] = cache["index"]
    return ref_run, port, model, tokens


@pytest.fixture(scope="module")
def fp32_runs():
    return _run_pair("float32")


def test_ssm_prefill_logits_match_jax(fp32_runs):
    ref_run, port, _, _ = fp32_runs
    assert port["prefill"].shape == ref_run["prefill"].shape == (B, 256)
    np.testing.assert_allclose(port["prefill"], ref_run["prefill"], **MODEL_TOL)
    assert port["index"] == ref_run["index"] == S


@pytest.mark.parametrize("when", ["cache", "final"])
@pytest.mark.parametrize("name", ["conv_x", "conv_b", "conv_c", "ssm"])
def test_ssm_cache_matches_jax(fp32_runs, name, when):
    """Both parts of the cache (conv windows, SSD state) after prefill and
    after the decode steps."""
    ref_run, port, _, _ = fp32_runs
    assert port[when][name].shape == ref_run[when][name].shape
    np.testing.assert_allclose(port[when][name], ref_run[when][name], **MODEL_TOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_ssm_decode_logits_and_greedy_tokens_match_jax(fp32_runs, step):
    ref_run, port, _, _ = fp32_runs
    np.testing.assert_allclose(port["decode"][step], ref_run["decode"][step], **MODEL_TOL)
    if step + 1 < STEPS:
        np.testing.assert_array_equal(port["decode"][step].argmax(-1),
                                      ref_run["tokens"][step + 1])
    assert port["index_after"] == S + STEPS


def test_ssm_prefill_then_decode_equals_forward(fp32_runs):
    ref_run, port, model, tokens = fp32_runs
    seq = np.concatenate([tokens, np.stack(ref_run["tokens"], 1)], axis=1)
    with torch.inference_mode():
        full = model(torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(port["prefill"], full[:, S - 1], **MODEL_TOL)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], full[:, S + step], **MODEL_TOL)


def test_ssm_bf16_slice_close_to_jax():
    """bf16 rounds at other places in the two frameworks (matmul outputs,
    the conv's products and sums): logits are held to 2e-2 absolute, the
    bf16 tolerance of tests/test_kernels.py. Greedy tokens are not compared."""
    ref_run, port, model, _ = _run_pair("bfloat16")
    blk = model.blocks[0].mamba
    assert blk["w_x"].dtype == torch.bfloat16
    assert all(blk[k].dtype == torch.float32 for k in ("a_log", "d_skip", "dt_bias"))
    np.testing.assert_allclose(port["prefill"], ref_run["prefill"], rtol=0, atol=2e-2)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], ref_run["decode"][step],
                                   rtol=0, atol=2e-2)


def test_ssm_params_match_jax_tree():
    """The port's parameter names, shapes and dtypes are the reference's
    tree: embed, blocks.{ln1, mamba.*} and final_norm, no lm_head (the
    reference unembeds with the embedding whatever tie_embeddings says)."""
    jcfg, tcfg = j_reduce(j_get_arch("mamba2-2.7b")), reduce_for_smoke(get_arch("mamba2-2.7b"))
    assert not tcfg.tie_embeddings
    specs = j_build_model(jcfg).param_specs()
    model = build_model(tcfg, device="meta")
    assert isinstance(model, MambaLM)
    flat = {"embed.w" if k == "embed" else k: v for k, v in _flatten(specs).items()}
    port = dict(model.named_parameters())
    for name, p in port.items():
        key = ".".join(n for i, n in enumerate(name.split(".")) if not (i == 1 and n.isdigit()))
        spec = flat[key]
        assert tuple(p.shape) == tuple(spec.shape[1:] if key.startswith("blocks") else spec.shape)
        assert str(p.dtype).split(".")[-1] == str(spec.dtype)
    assert len(flat) == 1 + 2 + 13


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_mamba2_full_param_count():
    """mamba2-2.7b at full width and depth, counted on the meta device:
    the reference's param_specs count, 5.41 GB of bf16 weights."""
    assert param_count(get_arch("mamba2-2.7b")) == 2_702_624_256


@pytest.mark.parametrize("smoke", [False, True])
def test_mamba2_config_copy_matches_jax(smoke):
    tcfg, jcfg = get_arch("mamba2-2.7b"), j_get_arch("mamba2-2.7b")
    if smoke:
        tcfg, jcfg = reduce_for_smoke(tcfg), j_reduce(jcfg)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert (tcfg.ssm_inner, tcfg.ssm_heads, tcfg.padded_vocab) == \
        (jcfg.ssm_inner, jcfg.ssm_heads, jcfg.padded_vocab)


def test_ssm_cache_specs_match_jax():
    """Per the reference: conv windows declared bf16 whatever the model
    dtype, the SSD state fp32, stacked on the layer axis."""
    jcfg, tcfg = j_reduce(j_get_arch("mamba2-2.7b")), reduce_for_smoke(get_arch("mamba2-2.7b"))
    want = j_build_model(jcfg).cache_specs(3, 40)["mamba"]
    got = build_model(tcfg, device="meta").cache_specs(3, 40)["mamba"]
    for name, spec in want.items():
        assert tuple(got[name].shape) == tuple(spec.shape)
        assert str(got[name].dtype).split(".")[-1] == str(spec.dtype)
