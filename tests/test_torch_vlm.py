"""The port's VLM (internvl2-26b's patch path) against the JAX package on
the CPU: the same reference parameters (``repro`` init, moved across with
``params_from_numpy``), the same prompts and the same patch embeddings
(``rng.normal``, as tests/test_models_smoke.py draws them) through JAX's
``_build_decoder_lm`` and the port's ``DecoderLM``, at the smoke size of
internvl2-26b (2 layers, 4 q / 2 kv heads of 16, 8 patch tokens); the
config at full width; and the plain decode at 6 q heads per kv head (the
full model's 48/8) against the Pallas kernel in interpret mode.

Tolerances: fp32 at 2e-4 (the reference's test_prefill_decode_matches_forward);
the plain decode at the fp32 / bf16 tolerances of tests/test_kernels.py."""
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
from repro.kernels import ops as jops
from repro.models import build_model as j_build_model
from repro.runtime.recovery import _flatten_opt as j_flatten_opt
from repro.train.state import init_state as j_init_state
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt import storage
from repro_torch.configs import SHAPES, get_arch, reduce_for_smoke
from repro_torch.kernels import ops as tops
from repro_torch.models import DecoderLM, build_model, param_count
from repro_torch.models.attention import merge_partials
from repro_torch.optim import adamw_init
from repro_torch.runtime.recovery import _flatten_opt
from repro_torch.train.serve import build_decode_step, build_prefill_step
from repro_torch.train.state import grad_tree, param_tree

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 2, 11, 8
NPATCH = 8
MAX_LEN = NPATCH + S + STEPS + 1
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(j_reduce(j_get_arch("internvl2-26b")), dtype=dtype)
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch("internvl2-26b")), dtype=dtype)
    return jcfg, tcfg


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _patches(seed, batch, d=64):
    return np.random.default_rng(seed).normal(size=(batch, NPATCH, d)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """JAX and port runs of forward, prefill + STEPS greedy decode steps
    (tokens chosen by JAX), from one parameter tree and one set of patch
    embeddings."""
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
    patches = _patches(4, B)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "patch_embeds": jnp.asarray(patches)}
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, {**b, "max_len": MAX_LEN}))(
        params, jbatch)
    ref = {"forward": _np(jax.jit(jmodel.forward)(params, jbatch)), "prefill": _np(jlogits),
           "k": _np(jcache["k"]), "v": _np(jcache["v"]), "index": int(jcache["index"]),
           "decode": [], "tokens": []}
    jdecode = jax.jit(jmodel.decode_step)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        ref["tokens"].append(np.asarray(tok))
        jlogits, jcache = jdecode(params, jcache, tok)
        ref["decode"].append(_np(jlogits))
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ref["final_k"], ref["final_v"] = _np(jcache["k"]), _np(jcache["v"])

    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tt, tp = torch.from_numpy(tokens), torch.from_numpy(patches)
    with torch.inference_mode():
        port = {"forward": _np(model(tt, tp))}
    logits, cache = build_prefill_step(model)(tt, MAX_LEN, tp)
    # copies: decode goes on to update the cache in place
    port.update(prefill=_np(logits), k=_np(cache["k"]).copy(), v=_np(cache["v"]).copy(),
                index=cache["index"], decode=[])
    decode = build_decode_step(model)
    for step in range(STEPS):
        logits, cache = decode(cache, torch.tensor(ref["tokens"][step], dtype=torch.long))
        port["decode"].append(_np(logits))
    port["final_k"], port["final_v"] = _np(cache["k"]), _np(cache["v"])
    port["index_after"] = cache["index"]
    return ref, port


def test_forward_matches_jax(runs):
    """Logits at every position, the patch positions first."""
    ref, port = runs
    assert port["forward"].shape == ref["forward"].shape == (B, NPATCH + S, 256)
    np.testing.assert_allclose(port["forward"], ref["forward"], **TOL)


def test_prefill_logits_and_index_match_jax(runs):
    ref, port = runs
    assert port["prefill"].shape == ref["prefill"].shape == (B, 256)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)
    assert port["index"] == ref["index"] == NPATCH + S
    np.testing.assert_allclose(port["prefill"], port["forward"][:, -1], **TOL)


@pytest.mark.parametrize("name", ["k", "v", "final_k", "final_v"])
def test_cache_matches_jax(runs, name):
    """The KV cache after prefill (the patches' positions first, zero from
    NPATCH + S on) and after the decode steps."""
    ref, port = runs
    assert port[name].shape == ref[name].shape == (2, B, MAX_LEN, 2, 16)
    np.testing.assert_allclose(port[name], ref[name], **TOL)
    if name == "k":
        assert np.abs(port[name][:, :, :NPATCH]).max() > 0
        assert not port[name][:, :, NPATCH + S:].any()


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_logits_and_greedy_tokens_match_jax(runs, step):
    ref, port = runs
    np.testing.assert_allclose(port["decode"][step], ref["decode"][step], **TOL)
    if step + 1 < STEPS:
        np.testing.assert_array_equal(port["decode"][step].argmax(-1), ref["tokens"][step + 1])
    assert port["index_after"] == NPATCH + S + STEPS


def test_default_max_len_counts_the_patches():
    """Without max_len the cache holds the patches and the prompt, as the
    reference's ``batch.get("max_len", S + num_patch_tokens)``."""
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 5), dtype=torch.long)
    _, cache = build_prefill_step(model)(tokens, None, torch.from_numpy(_patches(5, 1)))
    assert cache["k"].shape[2] == NPATCH + 5 and cache["index"] == NPATCH + 5


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
    """The loss scores the text positions only (xent over x[:, npatch:]),
    the labels the text's; every gradient, the untied head's included,
    against jax.value_and_grad."""
    jmodel, state, model = bridged
    tokens = np.random.default_rng(6).integers(0, 256, (3, 19))
    patches = _patches(7, 3)
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32),
                                  "patch_embeds": jnp.asarray(patches)}), has_aux=True)(
        state["params"])
    model.zero_grad(set_to_none=True)
    loss, aux = model.loss({"tokens": torch.from_numpy(tokens),
                            "patch_embeds": torch.from_numpy(patches)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(aux["xent"].item(), float(jaux["xent"]), **TOL)
    assert aux["aux"].item() == float(jaux["aux"]) == 0.0
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    # embed, final_norm, lm_head + 9 per stacked layer (ln1, wq, wk, wv, wo, ln2, 3 MLP)
    assert len(port) == len(ref) == 3 + 9
    for (path, got), (_, want) in zip(port, ref):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path), **TOL)
    model.zero_grad(set_to_none=True)


def test_opt_vector_and_npz_keys_are_the_references(bridged):
    """The VLM's state flattens to JAX's .npz keys (the dense decoder's tree
    with an untied lm_head) in jax.tree_util's order, and its opt vector is
    the reference's bit for bit; patch_embeds is an input, not a
    parameter."""
    _, state, model = bridged
    params = param_tree(model)
    port_state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
                  "opt": adamw_init(params)}
    port = storage._flatten(port_state)
    ref = j_storage._flatten(state)
    assert list(port) == list(ref)
    assert "params|lm_head|w" in port and not any("patch" in k for k in port)
    for key, arr in ref.items():
        assert port[key].shape == arr.shape and port[key].dtype == arr.dtype, key
    np.testing.assert_array_equal(_flatten_opt(port_state["opt"])[0],
                                  j_flatten_opt(state["opt"])[0])


def test_params_from_numpy_takes_the_references_tree_in_order():
    jcfg, tcfg = _cfgs("bfloat16")
    specs = jax.tree_util.tree_flatten_with_path(j_build_model(jcfg).param_specs())[0]
    ref = {tree.keystr(tuple(k.key for k in path)): s for path, s in specs}
    port = tree.tree_flatten_with_path(param_tree(build_model(tcfg, device="meta")))
    assert [tree.keystr(p) for p, _ in port] == list(ref)
    for path, leaf in port:
        spec = ref[tree.keystr(path)]
        assert tuple(leaf.shape) == tuple(spec.shape), path
        assert str(leaf.dtype).split(".")[-1] == str(spec.dtype), path


# -------------------------------- inputs --------------------------------- #
@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_jax(name):
    """Train and prefill take S - npatch (+1) tokens and patch_embeds (B,
    npatch, D) in the model dtype; decode one token and the cache."""
    jcfg, tcfg = j_get_arch("internvl2-26b"), get_arch("internvl2-26b")
    want = j_build_model(jcfg).input_specs(J_SHAPES[name])
    got = build_model(tcfg, device="meta").input_specs(SHAPES[name])
    flat_want = {tree.keystr(tuple(k.key for k in p)): s
                 for p, s in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = dict((tree.keystr(p), t) for p, t in tree.tree_flatten_with_path(got))
    flat_got.pop("cache|index", None)            # the port's index is a host int
    flat_want.pop("cache|index", None)
    assert sorted(flat_got) == sorted(flat_want)
    for key, spec in flat_want.items():
        assert tuple(flat_got[key].shape) == tuple(spec.shape), key
        assert str(flat_got[key].dtype).split(".")[-1] == str(spec.dtype), key
    if name != "decode_32k":
        assert tuple(got["patch_embeds"].shape) == (SHAPES[name].global_batch, 1024, 6144)


@pytest.mark.parametrize("case", ["missing", "short", "wide", "other_batch"])
@pytest.mark.parametrize("call", ["forward", "prefill", "loss"])
def test_vlm_without_its_patches_raises(call, case):
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu")
    tokens = torch.zeros((2, 6), dtype=torch.long)
    patches = {"missing": None, "short": torch.zeros(2, NPATCH - 1, 64),
               "wide": torch.zeros(2, NPATCH, 65), "other_batch": torch.zeros(1, NPATCH, 64)}[case]
    with pytest.raises(ValueError, match="needs patch_embeds"):
        if call == "forward":
            model(tokens, patches)
        elif call == "prefill":
            model.prefill(tokens, 20, patches)
        else:
            model.loss({"tokens": tokens} if patches is None
                       else {"tokens": tokens, "patch_embeds": patches})


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b"])
def test_other_models_given_patches_raise(arch):
    model = build_model(reduce_for_smoke(get_arch(arch)), device="cpu")
    tokens = torch.zeros((2, 6), dtype=torch.long)
    patches = torch.zeros(2, NPATCH, 64)
    with pytest.raises(ValueError, match="takes no patch_embeds"):
        model.prefill(tokens, 20, patches)
    with pytest.raises(ValueError, match="takes no patch_embeds"):
        model.loss({"tokens": tokens, "patch_embeds": patches})


# -------------------------------- config --------------------------------- #
def test_build_model_builds_a_decoder_with_an_untied_head():
    model = build_model(get_arch("internvl2-26b"), device="meta")
    assert isinstance(model, DecoderLM) and len(model.blocks) == 48
    assert tuple(model.lm_head["w"].shape) == (92_672, 6144)
    assert tuple(model.blocks[0].attn["wk"].shape) == (6144, 8 * 128)


def test_full_param_count():
    """internvl2-26b at full width and depth, counted on the meta device:
    the reference's count (39.7 GB of bf16 weights)."""
    assert param_count(get_arch("internvl2-26b")) == 19_862_722_560
    jparams = j_build_model(j_get_arch("internvl2-26b")).param_specs()
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jparams)) == 19_862_722_560


@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_jax(smoke):
    tcfg, jcfg = get_arch("internvl2-26b"), j_get_arch("internvl2-26b")
    if smoke:
        tcfg, jcfg = reduce_for_smoke(tcfg), j_reduce(jcfg)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert (tcfg.resolved_head_dim, tcfg.padded_vocab, tcfg.num_patch_tokens) == \
        (jcfg.resolved_head_dim, jcfg.padded_vocab, jcfg.num_patch_tokens)


def test_serve_cli_on_the_smoke_vlm():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke",
         "--arch", "internvl2-26b", "--batch", "2", "--prompt-len", "8", "--gen", "5"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "prefill: 2x8" in proc.stdout and "decoded 5 tokens/seq" in proc.stdout


def test_serve_cli_cache_counts_the_zero_patches(monkeypatch):
    """The CLI's patch embeddings are zeros in the model's dtype and its
    max_len counts them, as the reference CLI's."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    seen = {}
    prefill = transformer.DecoderLM.prefill

    def spy(self, tokens, max_len=None, patch_embeds=None, frames=None):
        seen.update(max_len=max_len, patches=patch_embeds.clone())
        return prefill(self, tokens, max_len, patch_embeds, frames)

    monkeypatch.setattr(transformer.DecoderLM, "prefill", spy)
    seqs = serve_cli.main(["--device", "cpu", "--smoke", "--arch", "internvl2-26b",
                           "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert seqs.shape == (2, 3) and seen["max_len"] == NPATCH + 6 + 3
    assert seen["patches"].shape == (2, NPATCH, 64) and not seen["patches"].any()
    assert seen["patches"].dtype == torch.bfloat16


# ------------------------- decode at group 6 ----------------------------- #
def _decode_inputs(seed, b, t, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, 1, 12, 16), (b, t, 2, 16), (b, t, 2, 16))]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len", [1, 33, 64])
def test_plain_decode_at_group6_matches_pallas(cur_len, dtype):
    """12 q heads on 2 kv heads: the plain decode (what the CUDA wrapper
    runs on CPU tensors) whole, and in the block form on two blocks merged,
    against the Pallas decode kernel in interpret mode."""
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    (qj, kj, vj), (qt, kt, vt) = _decode_inputs(21, 2, 64, dtype)
    pallas = _np(jops.decode_attention(qj, kj, vj, jnp.asarray(cur_len), bt=32))
    whole = tops.decode_attention(qt, kt, vt, cur_len)
    assert whole.dtype == qt.dtype and whole.shape == (2, 1, 12, 16)
    np.testing.assert_allclose(_np(whole), pallas, **tol)
    cut = 32
    parts = [tops.decode_attention_partial(qt, kt[:, :cut], vt[:, :cut], min(cur_len, cut)),
             tops.decode_attention_partial(qt, kt[:, cut:], vt[:, cut:], max(cur_len - cut, 0))]
    merged = merge_partials(torch.stack([o[:, 0] for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]))
    np.testing.assert_allclose(_np(merged.to(qt.dtype)), pallas[:, 0], **tol)
