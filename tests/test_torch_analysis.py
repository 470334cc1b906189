"""The port's analysis mode and recompute policies against the JAX package.

Analysis mode (``repro_torch.models.modes.analysis_mode``) routes every
kernel call site to its plain, cost-exact form: dense attention, the plain
decode attention, the unchunked cross-entropy and the parallel SSD
(``models.mamba2._ssd_parallel``). Its loss and every gradient are held
against the reference's own analysis mode, one smoke config per family, in
fp32 at 2e-4 (the serving slice's tolerance). The recompute policies of
``run_layer`` ("none", "full", "dots") are held against the reference's
``jax.checkpoint`` policies the same way, and by what each saves for the
backward.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import build_model as j_build_model
from repro.models import mamba2 as j_mamba2
from repro.models import modes as j_modes
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attn, flash_attention, ssd
from repro_torch.models import mamba2, modes
from repro_torch.models.mamba2 import _ssd_parallel, ssd_chunked
from repro_torch.train.state import grad_tree

TOL = dict(rtol=2e-4, atol=2e-4)          # the serving slice's fp32 tolerance
SSD_TOL = dict(rtol=2e-5, atol=2e-5)
FAMILIES = {"dense": "qwen3-0.6b", "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-7b", "vlm": "internvl2-26b", "encdec": "whisper-small"}


def _bridge(arch: str, **changes):
    """The reference's smoke model (fp32, ``changes`` applied to both
    configs), its initial params and the port's model holding them."""
    jcfg = dataclasses.replace(j_reduce(j_get_arch(arch)), dtype="float32", **changes)
    tcfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32", **changes)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    model.requires_grad_(True)
    return jmodel, jparams, model


def _batch(cfg, seed: int) -> dict:
    """Tokens (2, 17) and, where the family takes them, frames or patch
    embeddings drawn N(0, 1) from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 17))}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model), np.float32)
    if cfg.num_patch_tokens:
        batch["patch_embeds"] = rng.standard_normal((2, cfg.num_patch_tokens, cfg.d_model),
                                                    np.float32)
    return batch


def _launches():
    return (flash_attention.flash_attention.launches, decode_attn.decode_attention.launches,
            ssd.ssd.launches)


def _loss_and_grads_match(jmodel, jparams, model, batch, *, analysis: bool) -> None:
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
              for k, v in batch.items()}
    with j_modes.analysis_mode(analysis):
        (jl, jaux), jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, jbatch),
                                                        has_aux=True))(jparams)
    model.zero_grad(set_to_none=True)
    before = _launches()
    with modes.analysis_mode(analysis):
        assert modes.in_analysis_mode() is analysis
        loss, aux = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
    assert not modes.in_analysis_mode()
    assert _launches() == before          # the CPU route counts none either way
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(aux["aux"].item(), float(jaux["aux"]), **TOL)
    port = tree.tree_flatten_with_path(tree.tree_map(tree.to_numpy, grad_tree(model)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(port) == len(ref)
    for (path, got), (_, want) in zip(port, ref):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=tree.keystr(path), **TOL)
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_analysis_loss_and_every_gradient_match_jax(family):
    """Under both packages' analysis mode: the loss, the balance term and
    every gradient of one smoke config of each family."""
    jmodel, jparams, model = _bridge(FAMILIES[family])
    _loss_and_grads_match(jmodel, jparams, model, _batch(model.cfg, 3), analysis=True)


def test_analysis_mode_takes_the_plain_forms(monkeypatch):
    """Under analysis mode no kernel call site is reached (the wrappers in
    ``kernels.ops`` are replaced by ones that raise), the cross-entropy holds
    the whole logits, and the flag is off again after the block."""
    from repro_torch.kernels import ops

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel call site was reached under analysis mode")
    for name in ("flash_attention", "decode_attention", "decode_attention_partial", "ssd"):
        monkeypatch.setattr(ops, name, refuse)
    for arch in ("zamba2-7b", "whisper-small"):
        _, _, model = _bridge(arch)
        batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg, 4).items()}
        with modes.analysis_mode():
            model.loss(batch)[0].backward()
            with torch.no_grad():
                extra = {k: v for k, v in batch.items() if k != "tokens"}
                logits, cache = model.prefill(batch["tokens"], 20, **extra)
                model.decode_step(cache, logits.argmax(-1))
        assert not modes.in_analysis_mode()
        with pytest.raises(AssertionError, match="kernel call site"):
            model.loss(batch)


# ------------------------------ _ssd_parallel ------------------------------ #
def _ssd_inputs(seed: int, b: int, s: int, h: int, p: int, n: int):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.1, size=(b, s, h)),
            -rng.uniform(0.5, 2.0, size=(h,)), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, s, n)), rng.normal(size=(b, h, n, p))]
    return [np.asarray(a, np.float32) for a in arrs]


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (21, 8), (16, 16)])
def test_ssd_parallel_matches_ssd_chunked_and_jax(s, chunk, initial):
    """``_ssd_parallel`` against the port's ``ssd_chunked`` and the
    reference's ``_ssd_parallel`` (its ``ssd_chunked`` under analysis
    mode): y and the final state at 2e-5, a ragged last chunk included;
    the gradients of every input against ``ssd_chunked``'s."""
    arrs = _ssd_inputs(s + initial, 2, s, 3, 4, 8)
    with j_modes.analysis_mode():
        jy, jfinal = jax.jit(lambda *t: j_mamba2.ssd_chunked(
            *t[:5], chunk=chunk, initial_state=t[5] if initial else None))(
            *map(jnp.asarray, arrs[:6]))
    n_in = 6 if initial else 5
    grads = {}
    for name, fn in (("parallel", _ssd_parallel), ("chunked", ssd_chunked)):
        leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrs[:n_in]]
        y, final = fn(*leaves[:5], chunk=chunk, initial_state=leaves[5] if initial else None)
        (y.square().sum() + final.sum()).backward()
        grads[name] = [t.grad for t in leaves]
        for got, want in ((y, jy), (final, jfinal)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SSD_TOL)
    for got, want in zip(grads["parallel"], grads["chunked"]):
        torch.testing.assert_close(got, want, **SSD_TOL)


def test_ssd_parallel_gradient_stays_finite_where_the_in_chunk_decay_overflows():
    """A 256-position chunk whose decay passes fp32's range for j > i (a =
    -16, dt 0.05), as at full width: the reference's ``_ssd_parallel``
    (exp before the mask) gives NaN gradients there; the port's masks the
    exponent first, and its gradients equal the reference's at a chunk of
    16, where nothing overflows."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 256, 2, 8, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 0.05, np.float32)
    a = np.array([-16.0, -1.0], np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))

    def jgrad(chunk):
        with j_modes.analysis_mode():
            return jax.jit(jax.grad(
                lambda *t: j_mamba2.ssd_chunked(*t, bm, cm, chunk=chunk)[0].sum(),
                argnums=(0, 1, 2)))(x, dt, a)

    assert not np.isfinite(np.asarray(jgrad(256)[1])).all()      # the reference's NaN
    leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in (x, dt, a)]
    _ssd_parallel(*leaves, torch.from_numpy(bm), torch.from_numpy(cm),
                  chunk=256)[0].sum().backward()
    for name, t, want in zip(("x", "dt", "a"), leaves, jgrad(16)):
        assert torch.isfinite(t.grad).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), err_msg=name,
                                   rtol=2e-4, atol=2e-4 * np.abs(want).max())


def test_ssd_call_sites_take_the_parallel_form_under_analysis_mode(monkeypatch):
    """``mamba_apply`` and ``mamba_prefill`` reach ``_ssd_parallel`` under
    analysis mode and ``ops.ssd`` outside it."""
    seen = []
    real = mamba2._ssd_parallel
    monkeypatch.setattr(mamba2, "_ssd_parallel",
                        lambda *a, **kw: seen.append("parallel") or real(*a, **kw))
    _, _, model = _bridge("mamba2-2.7b")
    tokens = torch.from_numpy(_batch(model.cfg, 5)["tokens"])
    with torch.no_grad():
        with modes.analysis_mode():
            model.prefill(tokens, 20)
            model.loss({"tokens": tokens})
        assert seen == ["parallel"] * 2 * model.cfg.num_layers
        model.loss({"tokens": tokens})
    assert len(seen) == 2 * model.cfg.num_layers


def _call_sites(device):
    """Each kernel call site of the layers, called on small tensors on
    ``device``: name -> a thunk."""
    from repro_torch.models import attention, layers

    def t(*shape):
        return torch.ones(shape, device=device)
    return {
        "flash": lambda: attention._attend(t(1, 4, 2, 8), t(1, 4, 1, 8), t(1, 4, 1, 8),
                                           causal=True),
        "decode": lambda: attention._attend_cached(t(1, 1, 2, 8), t(1, 6, 1, 8),
                                                   t(1, 6, 1, 8), 3),
        "decode_block": lambda: attention._attend_cached(t(1, 1, 2, 8), t(1, 6, 1, 8),
                                                         t(1, 6, 1, 8), 3, partial=True),
        "ssd": lambda: mamba2._ssd(t(1, 8, 2, 4), t(1, 8, 2), -t(2), t(1, 8, 4), t(1, 8, 4),
                                   chunk=4),
        "xent": lambda: layers.chunked_xent(t(16, 8), t(1, 4, 8),
                                            torch.zeros(1, 4, dtype=torch.long,
                                                        device=device)),
    }


@pytest.mark.parametrize("site", ["flash", "decode", "decode_block", "ssd", "xent"])
def test_analysis_mode_on_a_cuda_tensor_raises(site):
    """Under analysis mode a call site that meets a CUDA tensor raises
    rather than take the plain form (a fake CUDA tensor stands for one
    here); on a CPU tensor, real or fake, it takes the plain form."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), modes.analysis_mode():
        with pytest.raises(RuntimeError, match="analysis mode on a CUDA tensor"):
            _call_sites("cuda")[site]()
        _call_sites("cpu")[site]()
    with modes.analysis_mode():
        _call_sites("cpu")[site]()
    assert not modes.analysis_form(torch.ones(1))


# ------------------------------ remat_policy ------------------------------- #
@pytest.mark.parametrize("policy", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b"])
def test_remat_policy_loss_and_every_gradient_match_jax(arch, policy):
    """The loss and every gradient under each ``remat_policy``, set on both
    packages' configs, against the reference's ``jax.checkpoint`` policy."""
    jmodel, jparams, model = _bridge(arch, remat_policy=policy)
    _loss_and_grads_match(jmodel, jparams, model, _batch(model.cfg, 6), analysis=False)


def _saved_bytes(policy: str, arch: str = "qwen3-0.6b"):
    """The bytes one layer body's forward hands to autograd to save
    (``saved_tensors_hooks``) under ``policy``, and its input's bytes."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype="float32",
                              remat_policy=policy)
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    x = torch.randn(2, 16, cfg.d_model, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model.blocks[0](x)
    (out[0] if isinstance(out, tuple) else out).sum().backward()
    return sum(saved), x.numel() * x.element_size()


def test_full_remat_saves_the_input_alone():
    """Under "full" a layer saves its input and nothing else (the body is
    recomputed in the backward); under "none" it saves strictly more."""
    full, inp = _saved_bytes("full")
    none, _ = _saved_bytes("none")
    assert full == inp
    assert none > full


def test_dots_saves_the_projections_and_no_attention_bmm(monkeypatch):
    """Under "dots" the selective-checkpoint policy saves each 2-D matmul
    output (the 7 projections of a SwiGLU block: wq, wk, wv, wo, w_gate,
    w_up, w_down) and recomputes every attention ``bmm``; the saved
    tensors' hooks see the input alone, as under "full"."""
    decisions = []
    real = modes._dots_policy

    def recording(ctx, op, *args, **kwargs):
        got = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op.overloadpacket, got))
        return got
    monkeypatch.setattr(modes, "_dots_policy", recording)
    dots, inp = _saved_bytes("dots")
    assert dots == inp
    saved = [op for op, got in decisions if got == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm] * 7
    bmm = [got for op, got in decisions if op is torch.ops.aten.bmm]
    assert bmm and all(got == torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
                       for got in bmm)


def test_an_unknown_remat_policy_raises():
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32",
                              remat_policy="sometimes")
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown remat policy sometimes"):
        model.loss({"tokens": torch.zeros((1, 5), dtype=torch.int64)})
    with pytest.raises(ValueError, match="unknown remat policy"):
        modes.run_layer(lambda x: x, torch.zeros(1), remat="sometimes")
