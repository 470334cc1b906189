"""The port's serving slice against the JAX package: the same reference
parameters (``repro`` init, moved across with ``params_from_numpy``) and the
same prompts through JAX ``prefill`` / ``decode_step`` and the port's, at the
smoke size of qwen3-0.6b, on the CPU."""
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, param_count
from repro_torch.models import transformer as ttf
from repro_torch.train.serve import build_decode_step, build_prefill_step

B, S, STEPS = 2, 12, 4
MAX_LEN = S + STEPS + 1
TOL = dict(rtol=2e-4, atol=2e-4)   # test_prefill_decode_matches_forward's


def _run_pair(dtype: str):
    """JAX and port runs of prefill + STEPS greedy decode steps (tokens
    chosen by JAX), from one parameter tree."""
    jcfg = dataclasses.replace(j_reduce(j_get_arch("qwen3-0.6b")), dtype=dtype)
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype=dtype)
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S))

    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t, "max_len": MAX_LEN}))
    jdecode = jax.jit(jmodel.decode_step)
    jlogits, jcache = jprefill(params, jnp.asarray(tokens, jnp.int32))
    ref = {"prefill": np.asarray(jlogits, np.float32),
           "cache": {k: np.asarray(v, np.float32) for k, v in jcache.items()},
           "decode": [], "tokens": []}
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        ref["tokens"].append(np.asarray(tok))
        jlogits, jcache = jdecode(params, jcache, tok)
        ref["decode"].append(np.asarray(jlogits, np.float32))
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)

    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prefill, decode = build_prefill_step(model), build_decode_step(model)
    logits, cache = prefill(torch.from_numpy(tokens), MAX_LEN)
    port = {"prefill": logits.numpy(),
            # copies: decode goes on to update the cache in place
            "cache": {"k": cache["k"].float().numpy().copy(),
                      "v": cache["v"].float().numpy().copy(),
                      "index": cache["index"]},
            "decode": [], "tokens": []}
    tok = logits.argmax(-1)
    for step in range(STEPS):
        port["tokens"].append(tok.numpy())
        # feed JAX's token so that one flipped argmax cannot derail the rest
        logits, cache = decode(cache, torch.tensor(ref["tokens"][step], dtype=torch.long))
        port["decode"].append(logits.numpy())
        tok = logits.argmax(-1)
    return ref, port, model, tokens


@pytest.fixture(scope="module")
def fp32_runs():
    return _run_pair("float32")


def test_prefill_logits_match_jax(fp32_runs):
    ref, port, _, _ = fp32_runs
    assert port["prefill"].dtype == np.float32
    assert port["prefill"].shape == ref["prefill"].shape == (B, 256)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **TOL)


@pytest.mark.parametrize("name", ["k", "v"])
def test_prefill_cache_matches_jax(fp32_runs, name):
    ref, port, _, _ = fp32_runs
    assert port["cache"][name].shape == ref["cache"][name].shape
    np.testing.assert_allclose(port["cache"][name], ref["cache"][name], **TOL)
    assert not port["cache"][name][:, :, S:].any()      # padded with zeros


def test_prefill_index(fp32_runs):
    ref, port, _, _ = fp32_runs
    assert port["cache"]["index"] == int(ref["cache"]["index"]) == S


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_logits_and_greedy_tokens_match_jax(fp32_runs, step):
    ref, port, _, _ = fp32_runs
    np.testing.assert_allclose(port["decode"][step], ref["decode"][step], **TOL)
    np.testing.assert_array_equal(port["tokens"][step], ref["tokens"][step])


def test_prefill_then_decode_equals_forward(fp32_runs):
    ref, port, model, tokens = fp32_runs
    seq = np.concatenate([tokens, np.stack(ref["tokens"], 1)], axis=1)
    with torch.inference_mode():
        full = model(torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(port["prefill"], full[:, S - 1], **TOL)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], full[:, S + step], **TOL)


def test_bf16_slice_close_to_jax():
    """bf16 rounds at other places in the two frameworks (matmul outputs,
    the decode path's casts), and the difference compounds over layers and
    steps: logits (O(0.5) here) are held to 2e-2 absolute, the bf16
    tolerance of tests/test_kernels.py; about 6e-3 is seen. Greedy tokens
    are not compared."""
    ref, port, _, _ = _run_pair("bfloat16")
    np.testing.assert_allclose(port["prefill"], ref["prefill"], rtol=0, atol=2e-2)
    for step in range(STEPS):
        np.testing.assert_allclose(port["decode"][step], ref["decode"][step],
                                   rtol=0, atol=2e-2)


def test_cli_smoke_on_cpu():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke"],
        capture_output=True, text=True, cwd=root, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "prefill: 4x16" in proc.stdout and "decoded 16 tokens/seq" in proc.stdout


def test_cli_main_returns_the_sequences(capsys):
    seqs = serve_cli.main(["--device", "cpu", "--smoke", "--batch", "2",
                           "--prompt-len", "8", "--gen", "4"])
    assert "decoded 4 tokens/seq" in capsys.readouterr().out
    assert seqs.shape == (2, 4)


def test_build_model_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_arch("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({}, get_arch("qwen3-0.6b"))


@pytest.mark.parametrize("family", ["encdec"])
def test_encdec_family_builds_with_a_tied_head(family):
    """The enc-dec family builds (it raised until it was ported): an
    ``EncDecLM`` whose head is its embedding (tied, no ``lm_head``), with
    no refusal; an unknown family still raises."""
    from repro_torch.models import EncDecLM
    cfg = get_arch("whisper-small")
    model = build_model(cfg, device="meta")
    assert cfg.family == family and isinstance(model, EncDecLM)
    assert not hasattr(model, "lm_head") and not cfg.tie_embeddings
    assert tuple(model.embed["w"].shape) == (cfg.padded_vocab, cfg.d_model)
    with pytest.raises(NotImplementedError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="other"), device="meta")


def test_vlm_family_builds_a_decoder_with_an_lm_head():
    """The VLM family builds (it raised until it was ported): a
    ``DecoderLM`` with its untied head, no refusal."""
    from repro_torch.models import DecoderLM
    cfg = get_arch("internvl2-26b")
    model = build_model(cfg, device="meta")
    assert cfg.family == "vlm" and isinstance(model, DecoderLM)
    assert tuple(model.lm_head["w"].shape) == (cfg.padded_vocab, cfg.d_model)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_configs_build_a_decoder_whose_blocks_hold_moe(arch):
    """The MoE family builds (it raised until it was ported): a
    ``DecoderLM`` whose every block holds the MoE layer and no MLP."""
    from repro_torch.models import DecoderLM
    from repro_torch.models.moe import MoEParams
    model = build_model(get_arch(arch), device="meta")
    assert isinstance(model, DecoderLM) and len(model.blocks) == get_arch(arch).num_layers
    assert all(isinstance(b.moe, MoEParams) and not hasattr(b, "mlp") for b in model.blocks)


def test_full_config_param_count():
    """qwen3-0.6b at full width: ~596 M parameters (1.19 GB in bf16),
    counted on the meta device without allocating."""
    n = param_count(get_arch("qwen3-0.6b"))
    assert n == 596_180_992
    jcfg = j_get_arch("qwen3-0.6b")
    assert get_arch("qwen3-0.6b").padded_vocab == jcfg.padded_vocab == 152_064


@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_jax(smoke):
    """The port's own copy of the config (and of reduce_for_smoke) agrees
    with the JAX package on every field the port keeps."""
    tcfg, jcfg = get_arch("qwen3-0.6b"), j_get_arch("qwen3-0.6b")
    if smoke:
        tcfg, jcfg = reduce_for_smoke(tcfg), j_reduce(jcfg)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert (tcfg.resolved_head_dim, tcfg.padded_vocab) == \
        (jcfg.resolved_head_dim, jcfg.padded_vocab)


def test_bridge_rejects_mismatched_tree():
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32")
    model = ttf.DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tree = {"embed": {"w": model.embed["w"].numpy()},
            "final_norm": model.final_norm.numpy(), "blocks": {}}
    with pytest.raises(KeyError):
        params_from_numpy(tree, cfg, device="cpu")


def test_decode_cache_is_updated_in_place():
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    logits, cache = build_prefill_step(model)(torch.zeros(1, 3, dtype=torch.long), 5)
    k_before = cache["k"]
    _, cache2 = build_decode_step(model)(cache, logits.argmax(-1))
    assert cache2["k"] is k_before and cache2["index"] == 4
    assert cache2["k"][:, :, 3].abs().sum() > 0 and not cache2["k"][:, :, 4].any()
