"""nemotron-4-15b (dense, 48 q heads on 8 kv heads of 128, the ungated
squared-ReLU MLP, vocab 256,000, untied head) in the port against the JAX
package, at smoke width on the CPU: the reference's parameters (``repro``
init, moved across with ``params_from_numpy``) through JAX ``prefill`` /
``decode_step`` and the port's. The smoke config keeps the family's group
of 6 q heads per kv head (12 q / 2 kv heads of 16, 2 layers), fp32, 2e-4.
"""
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
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models import build_model, param_count
from repro_torch.train.serve import build_decode_step, build_prefill_step
from repro_torch.train.state import grad_tree

ARCH = "nemotron-4-15b"
B, S, STEPS = 2, 12, 8
MAX_LEN = S + STEPS + 1
TOL = dict(rtol=2e-4, atol=2e-4)      # the serving slice's fp32 tolerance
GROUP6 = dict(num_heads=12, num_kv_heads=2, dtype="float32")


def _cfgs():
    return (dataclasses.replace(j_reduce(j_get_arch(ARCH)), **GROUP6),
            dataclasses.replace(reduce_for_smoke(get_arch(ARCH)), **GROUP6))


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
    return jmodel, params, model, ref, port


def test_smoke_config_keeps_the_family_shape():
    """The smoke config is the reference's, with 12 q / 2 kv heads: group 6
    as at full width, the squared-ReLU MLP (``w_up``, ``w_down``, no gate)
    and the untied head."""
    jcfg, tcfg = _cfgs()
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert tcfg.num_heads // tcfg.num_kv_heads == 48 // 8 == 6
    model = build_model(tcfg, device="meta")
    assert sorted(model.blocks[0].mlp.keys()) == ["w_down", "w_up"]
    assert tuple(model.lm_head["w"].shape) == (tcfg.padded_vocab, tcfg.d_model)


def test_prefill_logits_match_jax(runs):
    *_, ref, port = runs
    assert port["prefill"].shape == ref["prefill"].shape == (B, 256)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)


@pytest.mark.parametrize("when", ["cache", "final"])
@pytest.mark.parametrize("name", ["k", "v"])
def test_caches_match_jax(runs, name, when):
    """The caches after the prefill and after the decode steps."""
    *_, ref, port = runs
    assert port[when][name].shape == ref[when][name].shape == (2, B, MAX_LEN, 2, 16)
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
    all 11 gradients (embed, lm_head, final_norm, 8 a stacked block)."""
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
    """The full config field for field, and 15,628,376,064 parameters
    (31.26 GB of bf16) on both packages."""
    tcfg, jcfg = get_arch(ARCH), j_get_arch(ARCH)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    n = param_count(tcfg)
    assert n == j_param_count(jcfg)
    assert n == 15_628_376_064


def test_cli_smoke_on_cpu():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke",
         "--arch", ARCH], capture_output=True, text=True, cwd=root, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "decoded 16 tokens/seq" in proc.stdout
