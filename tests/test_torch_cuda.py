"""The CUDA kernels against their plain versions on the card, at small
shapes. Marked ``cuda``; each test skips where there is no GPU. Run on a
machine with one: ``PYTHONPATH=src python -m pytest -q -m cuda tests/``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn, flash_attention, ops
from repro_torch.kernels.ref import decode_attention_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)


def _rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh,hd", [(2, 100, 4, 2, 16), (1, 129, 4, 4, 32),
                                         (2, 64, 8, 1, 64), (1, 200, 16, 8, 128)])
def test_flash_kernel_matches_plain(cuda, b, s, h, kh, hd, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _rand(g, (b, s, h, hd), dtype, cuda)
    k = _rand(g, (b, s, kh, hd), dtype, cuda)
    v = _rand(g, (b, s, kh, hd), dtype, cuda)
    before = flash_attention.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    ref = ops.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur_len", [1, 63, 128])
@pytest.mark.parametrize("b,h,kh,hd", [(2, 4, 2, 16), (1, 8, 1, 64), (2, 16, 8, 128)])
def test_decode_kernel_matches_plain(cuda, b, h, kh, hd, cur_len, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    t = 128
    q = _rand(g, (b, 1, h, hd), dtype, cuda)
    kc = _rand(g, (b, t, kh, hd), dtype, cuda)
    vc = _rand(g, (b, t, kh, hd), dtype, cuda)
    before = decode_attn.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, cur_len)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    ref = decode_attention_ref(q, kc, vc, cur_len)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 24, device=cuda)           # head_dim 24
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 4, 16, device=cuda)
    kc = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        decode_attn.decode_attention(q, kc, kc, 9)       # cur_len > T
    with pytest.raises(ValueError):
        decode_attn.decode_attention(q.half(), kc.half(), kc.half(), 4)
