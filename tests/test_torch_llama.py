"""The paper's three LLaMA workloads (FFTrainer Table 4: llama3-8b, 32 q / 8
kv heads of 128, rope_theta 500,000, vocab 128,256; llama2-13b, MHA 40 / 40
of 128, vocab 32,000; llama3-70b, 64 q / 8 kv heads of 128, rope_theta
500,000; all SwiGLU with an untied head) in the port against the JAX
package, at smoke width on the CPU: the reference's parameters (``repro``
init, moved across with ``params_from_numpy``) through JAX ``prefill`` /
``decode_step`` / ``loss`` and the port's, fp32, 2e-4.

The smoke configs keep each model's head ratio and rope_theta, which
``reduce_for_smoke`` does not (it gives llama3-8b and llama3-70b group 2):
llama3-8b 8 q / 2 kv heads of 16 (group 4), llama2-13b 4 / 4 (MHA),
llama3-70b 8 / 1 (group 8); 2 layers, d_model 64, vocabulary 256."""
import dataclasses

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
from repro_torch.kernels import decode_attn, flash_attention
from repro_torch.models import build_model, param_count
from repro_torch.train.serve import build_decode_step, build_prefill_step
from repro_torch.train.state import grad_tree

B, S, STEPS = 2, 12, 8
MAX_LEN = S + STEPS + 1
TOL = dict(rtol=2e-4, atol=2e-4)      # the serving slice's fp32 tolerance
# arch -> the smoke config's heads (the full config's group kept)
HEADS = {"llama3-8b": dict(num_heads=8, num_kv_heads=2),
         "llama2-13b": dict(num_heads=4, num_kv_heads=4),
         "llama3-70b": dict(num_heads=8, num_kv_heads=1)}
ARCHS = sorted(HEADS)
# arch -> (parameters at full depth, q heads per kv head, rope_theta,
#          padded vocabulary)
FULL = {"llama3-8b": (8_030_261_248, 4, 500_000.0, 128_256),
        "llama2-13b": (13_015_864_320, 1, 10_000.0, 32_000),
        "llama3-70b": (70_553_706_496, 8, 500_000.0, 128_256)}


def _cfgs(arch):
    changes = dict(HEADS[arch], dtype="float32")
    return (dataclasses.replace(j_reduce(j_get_arch(arch)), **changes),
            dataclasses.replace(reduce_for_smoke(get_arch(arch)), **changes))


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """JAX and port runs of prefill + STEPS greedy decode steps (the port
    fed JAX's tokens), from one parameter tree; the port's model."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
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
    launches = (flash_attention.flash_attention.launches,
                decode_attn.decode_attention.launches)
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
    port["launches"] = (flash_attention.flash_attention.launches - launches[0],
                        decode_attn.decode_attention.launches - launches[1])
    return arch, jmodel, params, model, ref, port


def test_smoke_config_keeps_the_head_ratio_and_rope_theta(runs):
    """The smoke config is the reference's with the full config's q heads
    per kv head and rope_theta, SwiGLU (``w_gate``, ``w_up``, ``w_down``)
    and the untied head; the two packages' configs agree field for field."""
    arch, *_ = runs
    jcfg, tcfg = _cfgs(arch)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    _, group, theta, _ = FULL[arch]
    assert tcfg.num_heads // tcfg.num_kv_heads == group
    assert tcfg.rope_theta == theta and tcfg.mlp_type == "swiglu"
    assert not tcfg.tie_embeddings and not tcfg.use_qk_norm
    model = build_model(tcfg, device="meta")
    assert sorted(model.blocks[0].mlp.keys()) == ["w_down", "w_gate", "w_up"]
    assert tuple(model.lm_head["w"].shape) == (tcfg.padded_vocab, tcfg.d_model)


def test_prefill_logits_match_jax(runs):
    *_, ref, port = runs
    assert port["prefill"].shape == ref["prefill"].shape == (B, 256)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)


def test_cpu_run_launches_no_kernel(runs):
    """On CPU tensors every attention call site takes the plain version:
    no launch is counted."""
    *_, port = runs
    assert port["launches"] == (0, 0)


@pytest.mark.parametrize("when", ["cache", "final"])
@pytest.mark.parametrize("name", ["k", "v"])
def test_caches_match_jax(runs, name, when):
    """The caches after the prefill and after the decode steps: (layers, B,
    max_len, kv heads, 16)."""
    arch, *_, ref, port = runs
    kv = HEADS[arch]["num_kv_heads"]
    assert port[when][name].shape == ref[when][name].shape == (2, B, MAX_LEN, kv, 16)
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
    all 12 gradients (embed, lm_head, final_norm, 9 a stacked block: the
    four attention projections, the two norms, w_gate, w_up and w_down)."""
    _, jmodel, params, model, _, _ = runs
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
    assert len(port) == len(ref) == 3 + 9
    for (path, got), (_, want) in zip(port, ref):
        assert np.abs(want).max() > 0, tree.keystr(path)
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path), **TOL)
    model.requires_grad_(False)


def test_full_config_and_param_count_match_jax(runs):
    """The full config field for field and its parameter count on both
    packages (8.03 B, 13.02 B and 70.55 B: 16.1, 26.0 and 141.1 GB of
    bf16); llama3-70b cut to the 16 of its 80 layers that one card serves,
    15,791,824,896."""
    arch, *_ = runs
    tcfg, jcfg = get_arch(arch), j_get_arch(arch)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    n, group, theta, vocab = FULL[arch]
    assert param_count(tcfg) == j_param_count(jcfg) == n
    assert (tcfg.resolved_head_dim, tcfg.num_heads // tcfg.num_kv_heads, tcfg.rope_theta,
            tcfg.padded_vocab, tcfg.remat_policy) == (128, group, theta, vocab, "full")
    if arch == "llama3-70b":
        cut = dataclasses.replace(tcfg, num_layers=16)
        assert param_count(cut) == j_param_count(dataclasses.replace(jcfg, num_layers=16))
        assert param_count(cut) == 15_791_824_896
