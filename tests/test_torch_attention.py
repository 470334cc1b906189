"""The port's attention against the reference: the plain prefill and decode
functions (what the CUDA kernels' wrappers run on CPU tensors) against the
Pallas kernels in interpret mode and against the jnp paths they stand in
for. Tolerances are those of tests/test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attn as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref
from repro_torch.models import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh,hd", [(2, 128, 4, 2, 16), (1, 64, 4, 4, 32)])
def test_prefill_plain_matches_pallas_and_blockwise(b, s, h, kh, hd, causal, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(10, [(b, s, h, hd), (b, s, kh, hd),
                                              (b, s, kh, hd)], dtype)
    krep, vrep = jattn.repeat_kv(kj, h), jattn.repeat_kv(vj, h)
    pallas = jops.flash_attention(qj, krep, vrep, causal=causal, bq=64, bk=64)
    blockwise = jattn.blockwise_attention(qj, krep, vrep, causal=causal)
    out = tops.flash_attention(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype and out.shape == (b, s, h, hd)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(blockwise), **_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_dense_oracle_matches_reference_oracle(causal):
    (qj, kj, vj), (qt, kt, vt) = _inputs(11, [(2, 48, 4, 16), (2, 48, 2, 16),
                                              (2, 48, 2, 16)], "float32")
    ref = j_flash_ref(qj, jattn.repeat_kv(kj, 4), jattn.repeat_kv(vj, 4), causal=causal)
    out = flash_attention_ref(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol("float32"))


@pytest.mark.parametrize("s,kv_block", [(100, 32), (77, 1024), (1, 1024)])
def test_ragged_prefill_matches_blockwise(s, kv_block):
    """Lengths that are not a multiple of any tile: the reference pads and
    masks (the Pallas kernel asserts even tiling, so it is not compared)."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(12, [(2, s, 4, 16)] * 3, "float32")
    ref = jattn.blockwise_attention(qj, kj, vj, causal=True, kv_block=kv_block)
    out = tattn.blockwise_attention(qt, kt, vt, causal=True, kv_block=kv_block)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol("float32"))
    via_ops = tops.flash_attention(qt, kt, vt, causal=True)
    np.testing.assert_allclose(_np(via_ops), _np(ref), **_tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len", [1, 63, 128])
@pytest.mark.parametrize("b,t,h,kh,hd", [(2, 128, 4, 2, 16), (1, 128, 8, 1, 32)])
def test_decode_plain_matches_pallas_and_jnp(b, t, h, kh, hd, cur_len, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(13, [(b, 1, h, hd), (b, t, kh, hd),
                                              (b, t, kh, hd)], dtype)
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(cur_len), bt=32)
    jnp_path = jattn.decode_attention(qj, kj, vj, jnp.asarray(cur_len), h)
    out = tops.decode_attention(qt, kt, vt, cur_len)
    assert out.dtype == qt.dtype and out.shape == (b, 1, h, hd)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(jnp_path), **_tol(dtype))
    np.testing.assert_allclose(_np(decode_attention_ref(qt, kt, vt, cur_len)),
                               _np(out), rtol=0, atol=0)


def test_repeat_kv_is_jnp_repeat():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    ref = jattn.repeat_kv(jnp.asarray(x), 6)
    out = tattn.repeat_kv(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cpu_tensors_take_the_plain_version_and_never_launch():
    tfa.flash_attention.launches = 0
    tdec.decode_attention.launches = 0
    _, (q, k, v) = _inputs(14, [(1, 16, 4, 16), (1, 16, 2, 16), (1, 16, 2, 16)], "float32")
    tops.flash_attention(q, k, v, causal=True)
    tops.decode_attention(q[:, :1], k, v, 5)
    assert tfa.flash_attention.launches == 0
    assert tdec.decode_attention.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the wrappers launch on CUDA or raise."""
    _, (q, k, v) = _inputs(15, [(1, 16, 4, 16), (1, 16, 2, 16), (1, 16, 2, 16)], "float32")
    with pytest.raises(ValueError, match="not CUDA"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="not CUDA"):
        tdec.decode_attention(q[:, :1], k, v, 3)
    assert tfa.flash_attention.launches == 0
    assert tdec.decode_attention.launches == 0


def test_decode_write_past_cache_end_raises():
    from repro_torch.configs import get_arch, reduce_for_smoke
    cfg = reduce_for_smoke(get_arch("qwen3-0.6b"))
    p = tattn.attn_init(cfg, torch.float32, "cpu")
    tattn.init_attn(p, cfg, torch.Generator().manual_seed(0))
    kc = torch.zeros(1, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    x = torch.zeros(1, 1, cfg.d_model)
    with pytest.raises(IndexError):
        tattn.self_attention_decode(p, cfg, x, kc, kc.clone(), 4)
