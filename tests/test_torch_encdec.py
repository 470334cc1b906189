"""The port's encoder-decoder (whisper-small) against the JAX package on the
CPU: the same reference parameters (``repro`` init, moved across with
``params_from_numpy``), the same prompts and the same frame embeddings
(``rng.normal``) through JAX's ``_build_encdec`` and the port's
``EncDecLM``, at the smoke size of whisper-small (2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, 16 frames), fp32; its pieces
(``sinusoidal_positions``, ``cross_kv``, ``cross_attention``) on their own;
the config and ``param_count`` at full width; the serve CLI; and the mesh
steps' refusals.

Tolerance: fp32 at 2e-4 (the reference's test_prefill_decode_matches_forward)."""
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

from repro.ckpt import storage as j_storage
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import layers as jlayers
from repro.models.transformer import param_count as j_param_count
from repro.runtime.recovery import _flatten_opt as j_flatten_opt
from repro.train.state import init_state as j_init_state
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt import storage
from repro_torch.configs import SHAPES, get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attn, flash_attention
from repro_torch.models import EncDecLM, build_model, param_count
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.optim import adamw_init
from repro_torch.runtime.recovery import _flatten_opt
from repro_torch.train.serve import build_decode_step, build_prefill_step
from repro_torch.train.state import grad_tree, param_tree

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 2, 11, 8
SENC = 16                       # reduce_for_smoke's frames at the default seq_hint
MAX_LEN = S + STEPS + 1
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(j_reduce(j_get_arch("whisper-small")), dtype=dtype)
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch("whisper-small")), dtype=dtype)
    return jcfg, tcfg


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _frames(seed, batch, d=64, senc=SENC):
    return np.random.default_rng(seed).normal(size=(batch, senc, d)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """JAX and port runs of forward, prefill + STEPS greedy decode steps
    (tokens chosen by JAX), from one parameter tree and one set of frames."""
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
    frames = _frames(4, B)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "frames": jnp.asarray(frames)}
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, {**b, "max_len": MAX_LEN}))(
        params, jbatch)
    ref = {"forward": _np(jax.jit(jmodel.forward)(params, jbatch)), "prefill": _np(jlogits),
           "index": int(jcache["index"]), "decode": [], "tokens": []}
    ref.update({name: _np(jcache[name]) for name in ("k", "v", "cross_k", "cross_v")})
    jdecode = jax.jit(jmodel.decode_step)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        ref["tokens"].append(np.asarray(tok))
        jlogits, jcache = jdecode(params, jcache, tok)
        ref["decode"].append(_np(jlogits))
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ref.update({f"final_{name}": _np(jcache[name])
                for name in ("k", "v", "cross_k", "cross_v")})
    ref["index_after"] = int(jcache["index"])

    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tt, tf = torch.from_numpy(tokens), torch.from_numpy(frames)
    with torch.inference_mode():
        port = {"forward": _np(model(tt, tf))}
    launches = (flash_attention.flash_attention.launches, decode_attn.decode_attention.launches)
    logits, cache = build_prefill_step(model)(tt, MAX_LEN, None, tf)
    # copies: decode goes on to update the cache in place
    port.update(prefill=_np(logits), index=cache["index"], decode=[])
    port.update({name: _np(cache[name]).copy() for name in ("k", "v", "cross_k", "cross_v")})
    decode = build_decode_step(model)
    for step in range(STEPS):
        logits, cache = decode(cache, torch.tensor(ref["tokens"][step], dtype=torch.long))
        port["decode"].append(_np(logits))
    port.update({f"final_{name}": _np(cache[name])
                 for name in ("k", "v", "cross_k", "cross_v")})
    port["index_after"] = cache["index"]
    # the CPU runs the plain versions: no kernel wrapper is reached
    port["launches"] = (flash_attention.flash_attention.launches - launches[0],
                        decode_attn.decode_attention.launches - launches[1])
    return ref, port


def test_forward_matches_jax(runs):
    ref, port = runs
    assert port["forward"].shape == ref["forward"].shape == (B, S, 256)
    np.testing.assert_allclose(port["forward"], ref["forward"], **TOL)


def test_prefill_logits_and_index_match_jax(runs):
    ref, port = runs
    assert port["prefill"].shape == ref["prefill"].shape == (B, 256)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)
    assert port["index"] == ref["index"] == S
    np.testing.assert_allclose(port["prefill"], port["forward"][:, -1], **TOL)


@pytest.mark.parametrize("name", ["k", "v", "cross_k", "cross_v", "final_k", "final_v",
                                  "final_cross_k", "final_cross_v"])
def test_cache_matches_jax(runs, name):
    """The self cache after prefill (zero from S on) and after the decode
    steps; the cross cache (every frame) written by the prefill and
    unchanged by the steps."""
    ref, port = runs
    length = SENC if "cross" in name else MAX_LEN
    assert port[name].shape == ref[name].shape == (2, B, length, 4, 16)
    np.testing.assert_allclose(port[name], ref[name], **TOL)
    if name == "k":
        assert not port[name][:, :, S:].any()
    if name.startswith("final_cross"):
        np.testing.assert_array_equal(port[name], port[name[len("final_"):]])


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_logits_and_greedy_tokens_match_jax(runs, step):
    ref, port = runs
    np.testing.assert_allclose(port["decode"][step], ref["decode"][step], **TOL)
    if step + 1 < STEPS:
        np.testing.assert_array_equal(port["decode"][step].argmax(-1), ref["tokens"][step + 1])
    assert port["index_after"] == ref["index_after"] == S + STEPS


def test_cpu_runs_no_kernel(runs):
    assert runs[1]["launches"] == (0, 0)


# ------------------------------ the pieces ------------------------------- #
@pytest.mark.parametrize("seq,d_model", [(16, 64), (1500, 768), (7, 2), (5, 6)])
def test_sinusoidal_positions_are_the_references_bit_for_bit(seq, d_model):
    """The numpy table (float64, as the reference's), and its bf16 cast as
    the encoder takes it (``torch.to`` against ``jnp.asarray``)."""
    got, want = tlayers.sinusoidal_positions(seq, d_model), jlayers.sinusoidal_positions(seq, d_model)
    assert got.dtype == want.dtype and got.shape == (seq, d_model)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        torch.from_numpy(got).to(torch.bfloat16).float().numpy(),
        np.asarray(jnp.asarray(want, jnp.bfloat16).astype(jnp.float32)))


@pytest.fixture(scope="module")
def cross_params():
    """One cross-attention's reference parameters and the port's copy."""
    jcfg, tcfg = _cfgs()
    jp = jattn.cross_attn_init(jax.random.key(5), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def test_cross_kv_matches_jax(cross_params):
    jcfg, tcfg, jp, tp = cross_params
    assert sorted(jp) == sorted(tattn.cross_attn_init(tcfg, torch.float32, "meta")) == \
        ["wk", "wo", "wq", "wv"]
    enc = _frames(6, B)
    jk, jv = jattn.cross_kv(jp, jcfg, jnp.asarray(enc))
    tk, tv = tattn.cross_kv(tp, tcfg, torch.from_numpy(enc))
    assert tk.shape == tv.shape == (B, SENC, 4, 16)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_matches_jax(cross_params, sq):
    """S > 1 on the flash route (its plain version here), S = 1 on the
    decode route (``decode_attention_ref`` with cur_len = Senc), both
    against the reference's ``blockwise_attention(causal=False)``; S = 1
    under autograd stays on flash, so its gradient reaches k and v."""
    jcfg, tcfg, jp, tp = cross_params
    rng = np.random.default_rng(7 + sq)
    x = rng.normal(size=(B, sq, 64)).astype(np.float32)
    enc = _frames(8, B)
    jkv = jattn.cross_kv(jp, jcfg, jnp.asarray(enc))
    want = _np(jattn.cross_attention(jp, jcfg, jnp.asarray(x), jkv))
    tkv = tattn.cross_kv(tp, tcfg, torch.from_numpy(enc))
    with torch.no_grad():
        got = tattn.cross_attention(tp, tcfg, torch.from_numpy(x), tkv)
    assert got.shape == (B, sq, 64)
    np.testing.assert_allclose(_np(got), want, **TOL)
    k, v = (t.detach().requires_grad_() for t in tkv)
    out = tattn.cross_attention(tp, tcfg, torch.from_numpy(x), (k, v))
    out.sum().backward()
    np.testing.assert_allclose(_np(out.detach()), want, **TOL)
    assert k.grad is not None and v.grad is not None and v.grad.abs().sum() > 0


@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_routes(cross_params, sq, monkeypatch):
    """Which kernel wrapper a call would reach: one query outside autograd
    the decode one at cur_len = Senc, else flash non-causal."""
    from repro_torch.kernels import ops
    _, tcfg, _, tp = cross_params
    seen = []
    monkeypatch.setattr(ops, "decode_attention",
                        lambda q, k, v, cur_len: seen.append(("decode", cur_len)) or q)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, causal: seen.append(("flash", causal)) or q)
    kv = tattn.cross_kv(tp, tcfg, torch.from_numpy(_frames(9, B)))
    with torch.inference_mode():
        tattn.cross_attention(tp, tcfg, torch.zeros(B, sq, 64), kv)
    assert seen == ([("decode", SENC)] if sq == 1 else [("flash", False)])


# ------------------------------- training -------------------------------- #
@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg)
    state = j_init_state(jmodel, jax.random.key(1))
    model = params_from_numpy(jax.tree.map(np.asarray, state["params"]), tcfg, device="cpu")
    model.requires_grad_(True)
    return jmodel, state, model


def test_loss_and_every_gradient_match_jax(bridged):
    """The loss (xent of the tied head, aux 0) and every gradient, the
    encoder's and the cross-attention's included, against
    jax.value_and_grad."""
    jmodel, state, model = bridged
    tokens = np.random.default_rng(6).integers(0, 256, (3, 19))
    frames = _frames(7, 3)
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32),
                                  "frames": jnp.asarray(frames)}), has_aux=True)(
        state["params"])
    model.zero_grad(set_to_none=True)
    loss, aux = model.loss({"tokens": torch.from_numpy(tokens),
                            "frames": torch.from_numpy(frames)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(aux["xent"].item(), float(jaux["xent"]), **TOL)
    assert aux["aux"].item() == float(jaux["aux"]) == 0.0
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    # embed, enc_norm, final_norm + 8 a stacked encoder layer (ln1, wq, wk,
    # wv, wo, ln2, w_up, w_down) + 13 a decoder layer (those, ln_cross and
    # the cross-attention's four)
    assert len(port) == len(ref) == 3 + 8 + 13
    for (path, got), (_, want) in zip(port, ref):
        assert np.abs(want).max() > 0, tree.keystr(path)
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path), **TOL)
    model.zero_grad(set_to_none=True)


def test_opt_vector_and_npz_keys_are_the_references(bridged):
    """The enc-dec's state flattens to JAX's .npz keys (``encoder`` and
    ``decoder`` stacked, no ``lm_head``) in jax.tree_util's order, and its
    opt vector is the reference's bit for bit."""
    _, state, model = bridged
    params = param_tree(model)
    port_state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
                  "opt": adamw_init(params)}
    port = storage._flatten(port_state)
    ref = j_storage._flatten(state)
    assert list(port) == list(ref)
    assert "params|decoder|cross|wq" in port and not any("lm_head" in k for k in port)
    for key, arr in ref.items():
        assert port[key].shape == arr.shape and port[key].dtype == arr.dtype, key
    np.testing.assert_array_equal(_flatten_opt(port_state["opt"])[0],
                                  j_flatten_opt(state["opt"])[0])


def test_params_from_numpy_uses_every_leaf_in_order():
    """Every leaf of the reference's tree, the stacked encoder and decoder
    unstacked by layer, in jax.tree_util's order; a tree with a leaf more
    raises."""
    jcfg, tcfg = _cfgs("bfloat16")
    specs = jax.tree_util.tree_flatten_with_path(j_build_model(jcfg).param_specs())[0]
    ref = {tree.keystr(tuple(k.key for k in path)): s for path, s in specs}
    port = tree.tree_flatten_with_path(param_tree(build_model(tcfg, device="meta")))
    assert [tree.keystr(p) for p, _ in port] == list(ref) and len(ref) == 24
    for path, leaf in port:
        spec = ref[tree.keystr(path)]
        assert tuple(leaf.shape) == tuple(spec.shape), path
        assert str(leaf.dtype).split(".")[-1] == str(spec.dtype), path
    params = jax.tree.map(np.asarray, j_build_model(jcfg).init(jax.random.key(2)))
    model = params_from_numpy(params, tcfg, device="cpu")
    assert sum(1 for _ in model.parameters()) == 3 + 2 * 8 + 2 * 13
    params["encoder"]["extra"] = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="the trees differ"):
        params_from_numpy(params, tcfg, device="cpu")


# -------------------------------- inputs --------------------------------- #
@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_and_cache_specs_match_jax(name):
    """Train and prefill take the frames (B, encoder_seq, D) in the model
    dtype beside the tokens; decode one token and the cache, whose cross
    half holds encoder_seq positions."""
    want = j_build_model(j_get_arch("whisper-small")).input_specs(J_SHAPES[name])
    got = build_model(get_arch("whisper-small"), device="meta").input_specs(SHAPES[name])
    flat_want = {tree.keystr(tuple(k.key for k in p)): s
                 for p, s in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = dict((tree.keystr(p), t) for p, t in tree.tree_flatten_with_path(got))
    flat_got.pop("cache|index", None)            # the port's index is a host int
    flat_want.pop("cache|index", None)
    assert sorted(flat_got) == sorted(flat_want)
    for key, spec in flat_want.items():
        assert tuple(flat_got[key].shape) == tuple(spec.shape), key
        assert str(flat_got[key].dtype).split(".")[-1] == str(spec.dtype), key


@pytest.mark.parametrize("case", ["missing", "other_batch", "wide", "long"])
@pytest.mark.parametrize("call", ["forward", "prefill", "loss"])
def test_encdec_without_its_frames_raises(call, case):
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu")
    tokens = torch.zeros((2, 6), dtype=torch.long)
    frames = {"missing": None, "other_batch": torch.zeros(1, SENC, 64),
              "wide": torch.zeros(2, SENC, 65), "long": torch.zeros(2, SENC + 1, 64)}[case]
    with pytest.raises(ValueError, match="needs frames"):
        if call == "forward":
            model(tokens, frames)
        elif call == "prefill":
            model.prefill(tokens, 20, None, frames)
        else:
            model.loss({"tokens": tokens} if frames is None
                       else {"tokens": tokens, "frames": frames})


@pytest.mark.parametrize("seq", [1, SENC - 5, SENC])
def test_the_model_keeps_the_reference_positions(seq):
    """The model's position table (a buffer, not in its state dict) gives a
    clip of ``seq`` frames the reference's positions bit for bit, cast to the
    model's dtype."""
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu")
    want = np.asarray(jnp.asarray(jlayers.sinusoidal_positions(seq, 64), jnp.float32))
    assert "positions" not in model.state_dict()
    assert np.array_equal(model.positions[:seq].numpy(), want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-26b", "mamba2-2.7b", "zamba2-7b"])
def test_other_models_given_frames_raise(arch):
    model = build_model(reduce_for_smoke(get_arch(arch)), device="cpu")
    with pytest.raises(ValueError, match="takes no frames"):
        build_prefill_step(model)(torch.zeros((2, 6), dtype=torch.long), 20, None,
                                  torch.zeros(2, SENC, 64))


def test_encdec_given_patches_raises():
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu")
    with pytest.raises(ValueError, match="takes no patch_embeds"):
        model.prefill(torch.zeros((2, 6), dtype=torch.long), 20, torch.zeros(2, 8, 64),
                      torch.zeros(2, SENC, 64))


# -------------------------------- config --------------------------------- #
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_jax(smoke):
    tcfg, jcfg = get_arch("whisper-small"), j_get_arch("whisper-small")
    if smoke:
        tcfg, jcfg = reduce_for_smoke(tcfg), j_reduce(jcfg)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert (tcfg.resolved_head_dim, tcfg.padded_vocab) == \
        (jcfg.resolved_head_dim, jcfg.padded_vocab)


@pytest.mark.parametrize("seq_hint", [None, 8, 20, 64])
def test_reduce_for_smoke_keeps_both_stacks_as_jax(seq_hint):
    """2 encoder layers of max(8, seq_hint // 2) frames (16 at the default
    seq_hint of 32), every field as the reference's."""
    kw = {} if seq_hint is None else {"seq_hint": seq_hint}
    got = reduce_for_smoke(get_arch("whisper-small"), **kw)
    want = j_reduce(j_get_arch("whisper-small"), **kw)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert (got.encoder_layers, got.encoder_seq) == \
        (2, {None: 16, 8: 8, 20: 10, 64: 32}[seq_hint])
    assert reduce_for_smoke(get_arch("qwen3-0.6b"), seq_hint=64) == \
        reduce_for_smoke(get_arch("qwen3-0.6b"))


def test_full_model_and_param_count():
    """whisper-small at full width and depth on the meta device: 12 + 12
    layers, the tied head, the reference's 238,139,904 parameters."""
    model = build_model(get_arch("whisper-small"), device="meta")
    assert isinstance(model, EncDecLM) and (len(model.encoder), len(model.decoder)) == (12, 12)
    assert tuple(model.embed["w"].shape) == (51_968, 768)
    assert not hasattr(model.encoder[0], "cross") and hasattr(model.decoder[0], "cross")
    assert param_count(get_arch("whisper-small")) == 238_139_904 == \
        j_param_count(j_get_arch("whisper-small"))
    cache = model.cache_specs(8, 48)
    assert tuple(cache["k"].shape) == (12, 8, 48, 12, 64)
    assert tuple(cache["cross_k"].shape) == (12, 8, 1500, 12, 64)


# ---------------------------------- CLI ---------------------------------- #
def test_serve_cli_on_the_smoke_encdec():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "whisper-small",
         "--smoke", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "prefill: 4x16" in proc.stdout and "decoded 16 tokens/seq" in proc.stdout


def test_serve_cli_draws_the_references_frames(monkeypatch):
    """The CLI's frames are rng.normal from the seeded generator after the
    tokens, in bf16, as the reference CLI's; the cache holds prompt + gen."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    seen = {}
    prefill = transformer.EncDecLM.prefill

    def spy(self, tokens, max_len=None, patch_embeds=None, frames=None):
        seen.update(max_len=max_len, frames=frames.clone(), tokens=tokens.clone())
        return prefill(self, tokens, max_len, patch_embeds, frames)

    monkeypatch.setattr(transformer.EncDecLM, "prefill", spy)
    seqs = serve_cli.main(["--device", "cpu", "--smoke", "--arch", "whisper-small",
                           "--batch", "2", "--prompt-len", "6", "--gen", "3", "--seed", "4"])
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (2, 6))
    frames = rng.normal(size=(2, SENC, 64))
    assert seqs.shape == (2, 3) and seen["max_len"] == 6 + 3
    np.testing.assert_array_equal(seen["tokens"].numpy(), tokens)
    assert seen["frames"].dtype == torch.bfloat16
    np.testing.assert_array_equal(seen["frames"].float().numpy(),
                                  torch.from_numpy(frames).to(torch.bfloat16).float().numpy())


# --------------------------------- mesh ---------------------------------- #
@pytest.mark.parametrize("step", ["prefill", "decode", "train"])
def test_mesh_steps_refuse_the_encdec(step):
    """On a mesh the three steps refuse an enc-dec, naming its ROADMAP item;
    a (1, 1) mesh needs no process."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.step import build_train_step
    model = build_model(reduce_for_smoke(get_arch("whisper-small")), device="meta")
    mesh = Mesh(("data", "model"), (1, 1))
    with pytest.raises(NotImplementedError, match="11b-ii"):
        if step == "prefill":
            build_prefill_step(model, mesh, SHAPES["prefill_32k"])
        elif step == "decode":
            build_decode_step(model, mesh, SHAPES["decode_32k"])
        else:
            build_train_step(model, mesh)
