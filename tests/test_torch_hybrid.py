"""The port's hybrid (Zamba2) LM against the JAX package on the CPU: the
same reference parameters (``repro`` init, moved across with
``params_from_numpy``) and the same prompts through JAX ``prefill`` /
``decode_step`` / ``loss`` and the port's, at the smoke size of zamba2-7b
(4 layers, the shared attention block after layers 1 and 3), and the
zamba2-7b config at full width.

Tolerances: fp32 at 2e-4 (the reference's test_prefill_decode_matches_forward),
bf16 logits at 2e-2 absolute (the bf16 tolerance of tests/test_kernels.py)."""
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
from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import build_model as j_build_model
from repro.runtime.recovery import _flatten_opt as j_flatten_opt
from repro.train.state import init_state as j_init_state
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt import storage
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models import build_model, param_count
from repro_torch.models.transformer import HybridLM, SharedAttnBlock
from repro_torch.optim import adamw_init
from repro_torch.runtime.recovery import _flatten_opt
from repro_torch.train.serve import build_decode_step, build_prefill_step
from repro_torch.train.state import grad_tree, param_tree

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 2, 11, 8
MAX_LEN = S + STEPS + 1
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(j_reduce(j_get_arch("zamba2-7b")), dtype=dtype)
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch("zamba2-7b")), dtype=dtype)
    return jcfg, tcfg


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _run_pair(dtype: str):
    """JAX and port runs of prefill + STEPS greedy decode steps (tokens
    chosen by JAX), from one parameter tree."""
    jcfg, tcfg = _cfgs(dtype)
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
    jlogits, jcache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t, "max_len": MAX_LEN}))(
        params, jnp.asarray(tokens, jnp.int32))
    jdecode = jax.jit(jmodel.decode_step)

    def cache_np(c):
        return {"k": _np(c["k"]), "v": _np(c["v"]),
                **{f"mamba.{k}": _np(v) for k, v in c["mamba"].items()}}

    ref = {"prefill": _np(jlogits), "cache": cache_np(jcache), "index": int(jcache["index"]),
           "decode": [], "tokens": []}
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        ref["tokens"].append(np.asarray(tok))
        jlogits, jcache = jdecode(params, jcache, tok)
        ref["decode"].append(_np(jlogits))
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ref["final"] = cache_np(jcache)

    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    logits, cache = prefill(torch.from_numpy(tokens), MAX_LEN)
    # copies: decode goes on to update the cache in place
    port = {"prefill": _np(logits), "index": cache["index"],
            "cache": {k: v.copy() for k, v in cache_np(cache).items()}, "decode": []}
    for step in range(STEPS):
        logits, cache = decode(cache, torch.tensor(ref["tokens"][step], dtype=torch.long))
        port["decode"].append(_np(logits))
    port["final"] = cache_np(cache)
    port["index_after"] = cache["index"]
    return ref, port, model, tokens


@pytest.fixture(scope="module")
def fp32_runs():
    return _run_pair("float32")


def test_smoke_config_keeps_the_attention_cadence():
    _, tcfg = _cfgs()
    assert (tcfg.num_layers, tcfg.attn_every) == (4, 2)
    assert tcfg.layer_kinds() == ("mamba", "mamba_attn", "mamba", "mamba_attn")


def test_prefill_logits_match_jax(fp32_runs):
    ref, port, _, _ = fp32_runs
    assert port["prefill"].shape == ref["prefill"].shape == (B, 256)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)
    assert port["index"] == ref["index"] == S


@pytest.mark.parametrize("when", ["cache", "final"])
@pytest.mark.parametrize("name", ["k", "v", "mamba.conv_x", "mamba.conv_b", "mamba.conv_c",
                                  "mamba.ssm"])
def test_cache_matches_jax(fp32_runs, name, when):
    """The shared block's KV cache (one slot per application, zero past the
    written positions) and the Mamba2 states, after prefill and after the
    decode steps."""
    ref, port, _, _ = fp32_runs
    assert port[when][name].shape == ref[when][name].shape
    np.testing.assert_allclose(port[when][name], ref[when][name], **TOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_logits_and_greedy_tokens_match_jax(fp32_runs, step):
    ref, port, _, _ = fp32_runs
    np.testing.assert_allclose(port["decode"][step], ref["decode"][step], **TOL)
    if step + 1 < STEPS:
        np.testing.assert_array_equal(port["decode"][step].argmax(-1), ref["tokens"][step + 1])
    assert port["index_after"] == S + STEPS


def test_prefill_then_decode_equals_forward(fp32_runs):
    ref, port, model, tokens = fp32_runs
    seq = np.concatenate([tokens, np.stack(ref["tokens"], 1)], axis=1)
    with torch.inference_mode():
        full = model(torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(port["prefill"], full[:, S - 1], **TOL)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], full[:, S + step], **TOL)


def test_bf16_slice_close_to_jax():
    """bf16 rounds at other places in the two frameworks: logits held to
    2e-2 absolute; greedy tokens are not compared."""
    ref, port, model, _ = _run_pair("bfloat16")
    assert model.shared_attn.attn["wq"].dtype == torch.bfloat16
    np.testing.assert_allclose(port["prefill"], ref["prefill"], rtol=0, atol=2e-2)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], ref["decode"][step], rtol=0, atol=2e-2)


# ------------------------------- training -------------------------------- #
@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = _cfgs()
    jmodel = j_build_model(jcfg)
    state = j_init_state(jmodel, jax.random.key(1))
    host = jax.tree.map(np.asarray, state)
    model = params_from_numpy(host["params"], tcfg, device="cpu")
    model.requires_grad_(True)
    return jmodel, state, model


def test_loss_and_every_gradient_match_jax(bridged):
    """The hybrid's loss and all its gradients, the shared block's summed
    over its two applications, against jax.value_and_grad."""
    jmodel, state, model = bridged
    tokens = np.random.default_rng(6).integers(0, 256, (3, 19))
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)}),
        has_aux=True)(state["params"])
    model.zero_grad(set_to_none=True)
    loss, aux = model.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(aux["xent"].item(), float(jaux["xent"]), **TOL)
    assert aux["aux"].item() == float(jaux["aux"]) == 0.0
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    # 2 (embed, final_norm) + 14 per Mamba2 layer + 9 of the shared block
    assert len(port) == len(ref) == 2 + 14 + 9
    shared = 0
    for (path, got), (_, want) in zip(port, ref):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path), **TOL)
        if path[0] == "shared_attn":
            shared += 1
            assert np.abs(got).max() > 0, tree.keystr(path)
    assert shared == 9
    model.zero_grad(set_to_none=True)


def test_shared_block_gradient_sums_over_its_applications(bridged):
    """With the cadence set so that the block runs once (attn_every 4),
    its gradient differs from the two-application one: the gradient is
    accumulated per application, not taken from one."""
    _, _, model = bridged
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 9)))
    grads = []
    for every in (2, 4):
        m = HybridLM(dataclasses.replace(model.cfg, attn_every=every), device="cpu")
        m.load_state_dict(model.state_dict())
        m.requires_grad_(True)
        assert len(m.attn_layers) == 4 // every
        m.loss({"tokens": tokens})[0].backward()
        grads.append(m.shared_attn.attn["wq"].grad.clone())
    assert not torch.allclose(grads[0], grads[1])


def test_opt_vector_and_npz_keys_are_the_references(bridged):
    """The hybrid's state flattens to JAX's .npz keys (embed, blocks,
    final_norm, shared_attn in jax.tree_util's order, the shared block's
    leaves unstacked beside the stacked blocks) and its opt vector is the
    reference's bit for bit."""
    _, state, model = bridged
    params = param_tree(model)
    port_state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
                  "opt": adamw_init(params)}
    port = storage._flatten(port_state)
    ref = j_storage._flatten(state)
    assert list(port) == list(ref)
    assert "params|shared_attn|attn|wq" in port and port["params|shared_attn|attn|wq"].ndim == 2
    for key, arr in ref.items():
        assert port[key].shape == arr.shape and port[key].dtype == arr.dtype, key
    np.testing.assert_array_equal(_flatten_opt(port_state["opt"])[0],
                                  j_flatten_opt(state["opt"])[0])


# -------------------------------- config --------------------------------- #
def test_build_model_builds_the_hybrid():
    _, tcfg = _cfgs()
    model = build_model(tcfg, device="cpu")
    assert isinstance(model, HybridLM) and isinstance(model.shared_attn, SharedAttnBlock)
    assert model.attn_layers == (1, 3) and not hasattr(model, "lm_head")


def test_params_match_jax_tree():
    jcfg, tcfg = _cfgs("bfloat16")
    specs = jax.tree_util.tree_flatten_with_path(j_build_model(jcfg).param_specs())[0]
    ref = {tree.keystr(tuple(k.key for k in path)): s for path, s in specs}
    port = tree.tree_flatten_with_path(param_tree(build_model(tcfg, device="meta")))
    assert [tree.keystr(p) for p, _ in port] == list(ref)
    for path, leaf in port:
        spec = ref[tree.keystr(path)]
        assert tuple(leaf.shape) == tuple(spec.shape), path
        assert str(leaf.dtype).split(".")[-1] == str(spec.dtype), path


def test_full_param_count():
    """zamba2-7b at full width and depth, counted on the meta device: the
    reference's count (13.3 GB of bf16 weights)."""
    assert param_count(get_arch("zamba2-7b")) == 6_635_851_856
    jparams = j_build_model(j_get_arch("zamba2-7b")).param_specs()
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jparams)) == 6_635_851_856


@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_jax(smoke):
    tcfg, jcfg = get_arch("zamba2-7b"), j_get_arch("zamba2-7b")
    if smoke:
        tcfg, jcfg = reduce_for_smoke(tcfg), j_reduce(jcfg)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert tcfg.layer_kinds() == jcfg.layer_kinds()
    assert (tcfg.resolved_head_dim, tcfg.ssm_heads, tcfg.padded_vocab) == \
        (jcfg.resolved_head_dim, jcfg.ssm_heads, jcfg.padded_vocab)


def test_cache_specs_match_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    want = j_build_model(jcfg).cache_specs(3, 40)
    got = build_model(tcfg, device="meta").cache_specs(3, 40)
    flat_want = {**{f"mamba.{k}": v for k, v in want["mamba"].items()},
                 "k": want["k"], "v": want["v"]}
    flat_got = {**{f"mamba.{k}": v for k, v in got["mamba"].items()},
                "k": got["k"], "v": got["v"]}
    assert sorted(flat_got) == sorted(flat_want)
    for name, spec in flat_want.items():
        assert tuple(flat_got[name].shape) == tuple(spec.shape), name
        assert str(flat_got[name].dtype).split(".")[-1] == str(spec.dtype), name


def test_serve_cli_on_the_smoke_hybrid():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke",
         "--arch", "zamba2-7b", "--batch", "2", "--prompt-len", "8", "--gen", "5"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "prefill: 2x8" in proc.stdout and "decoded 5 tokens/seq" in proc.stdout


@pytest.mark.cuda
def test_hybrid_on_the_card_matches_the_cpu():
    """The smoke hybrid at head_dim 112, fp32: prefill, decode and the loss
    with every gradient on the card (fp32 flash and decode kernels at hd
    112, the SSD's fp32 route under autograd) against the same weights on
    the CPU, at 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tcfg = _cfgs()
    cfg = dataclasses.replace(tcfg, head_dim=112)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 23)))
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        logits, cache = build_prefill_step(model)(tokens[:, :20].to(model.device), 24)
        logits2, _ = build_decode_step(model)(cache, tokens[:, 20].to(model.device))
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": tokens.to(model.device)})
        loss.backward()
        outs[name] = [logits.cpu(), logits2.cpu(), loss.detach().cpu()] + [
            p.grad.cpu() for p in model.parameters()]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, **TOL)
