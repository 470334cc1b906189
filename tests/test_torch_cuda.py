"""The CUDA kernels against their plain versions on the card, at small
shapes. Marked ``cuda``; each test skips where there is no GPU. Run on a
machine with one: ``PYTHONPATH=src python -m pytest -q -m cuda tests/``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn, flash_attention, ops, ssd
from repro_torch.kernels.ref import decode_attention_ref, ssd_intra_chunk_ref, ssd_ref

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
                                         (2, 64, 8, 1, 64), (1, 200, 16, 8, 128),
                                         (2, 130, 4, 4, 112), (1, 70, 8, 2, 112),
                                         (2, 130, 4, 4, 80), (1, 70, 8, 1, 80),
                                         (2, 100, 8, 1, 256), (1, 129, 4, 1, 256)])
def test_flash_kernel_matches_plain(cuda, b, s, h, kh, hd, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _rand(g, (b, s, h, hd), dtype, cuda)
    k = _rand(g, (b, s, kh, hd), dtype, cuda)
    v = _rand(g, (b, s, kh, hd), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    before = flash_attention.flash_attention.launches
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    assert flash_attention.flash_attention.routes[route] == routed + 1
    ref = ops.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


def _wgmma_case(cuda, q, k, v, causal):
    """One bf16 call on the tensor-core route against the plain version."""
    routes = flash_attention.flash_attention.routes
    before = dict(routes)
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert routes["wgmma"] == before["wgmma"] + 1 and routes["fp32"] == before["fp32"]
    ref = ops.flash_attention_plain(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 100, 129, 1000])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 112, 128, 256])
def test_flash_wgmma_matches_plain(cuda, hd, s, causal, group):
    """Every head_dim and swizzle width, lengths below, at and across the
    64-row warpgroup, 128-row block and kv-tile edges, G q heads per kv
    head."""
    g = torch.Generator(device=cuda).manual_seed(2)
    kh = 2
    q = _rand(g, (1, s, kh * group, hd), torch.bfloat16, cuda)
    k = _rand(g, (1, s, kh, hd), torch.bfloat16, cuda)
    v = _rand(g, (1, s, kh, hd), torch.bfloat16, cuda)
    _wgmma_case(cuda, q, k, v, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,h,kh,hd", [(2, 200, 200, 8, 2, 128), (1, 100, 300, 4, 2, 64),
                                              (2, 300, 77, 4, 1, 32), (1, 129, 129, 2, 2, 16)])
def test_flash_wgmma_strided_views(cuda, b, sq, skv, h, kh, hd, causal):
    """q, k, v as 16-byte aligned views of one fused (B, S, H+2K, hd)
    projection, as a fused qkv product would give them; and Sq != Skv."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = _rand(g, (b, max(sq, skv), h + 2 * kh, hd), torch.bfloat16, cuda)
    q, k, v = qkv[:, :sq, :h], qkv[:, :skv, h:h + kh], qkv[:, :skv, h + kh:]
    assert not q.is_contiguous() and not k.is_contiguous()
    _wgmma_case(cuda, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("b,sq,skv", [(2, 200, 200), (1, 100, 300), (2, 300, 77), (1, 1000, 1000)])
def test_flash_hd256_matches_plain(cuda, b, sq, skv, group, causal, dtype):
    """head_dim 256 (gemma-2b's MQA heads) on both routes: one kv head
    read by 4 or 8 q heads, Sq equal to Skv and not."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = _rand(g, (b, sq, group, 256), dtype, cuda)
    k = _rand(g, (b, skv, 1, 256), dtype, cuda)
    v = _rand(g, (b, skv, 1, 256), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    ref = ops.flash_attention_plain(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == dtype
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh", [(2, 300, 48, 8), (1, 129, 12, 2), (2, 1000, 12, 2)])
def test_flash_group6_matches_plain(cuda, b, s, h, kh, causal, dtype):
    """6 q heads per kv head (internvl2-26b's 48/8 at head_dim 128, and its
    12/2 part) on both routes: q head h reads kv head h // 6. Each kv head
    is given its own offset, so that a q head reading a neighbour's would
    miss the plain version."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q = _rand(g, (b, s, h, 128), dtype, cuda)
    k = _rand(g, (b, s, kh, 128), dtype, cuda)
    v = (_rand(g, (b, s, kh, 128), torch.float32, cuda)
         + torch.arange(kh, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    ref = ops.flash_attention_plain(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == dtype
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_group6_at_a_vlm_mesh_rank(cuda, dtype):
    """A rank's attention in internvl2-26b's sharded step on (data 2, model
    2): its 24 q and 4 kv heads of 128 over 4 rows of 1,024 patches + 1,024
    tokens, causal; the forward on the kernel and the gradient into q, k
    and v under ``FlashAttention`` against autograd through the plain
    version. Each kv head's values carry their own offset."""
    g = torch.Generator(device=cuda).manual_seed(19)
    b, s, h, kh = 4, 2048, 24, 4
    q = _rand(g, (b, s, h, 128), dtype, cuda).requires_grad_()
    k = _rand(g, (b, s, kh, 128), dtype, cuda).requires_grad_()
    v = (_rand(g, (b, s, kh, 128), torch.float32, cuda)
         + torch.arange(kh, device=cuda, dtype=torch.float32)[:, None]).to(dtype).requires_grad_()
    dout = _rand(g, (b, s, h, 128), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    grads = torch.autograd.grad(out, (q, k, v), dout)
    ref = ops.flash_attention_plain(q, k, v, causal=True)
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)
    assert out.shape == q.shape and out.dtype == dtype
    for got, want in zip((out,) + grads, (ref,) + ref_grads):
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   want.detach().float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_head_major_views(cuda, causal):
    """q, k, v as transposes of (B, heads, S, hd) tensors: the head stride
    exceeds the position stride, which the tensor maps take as they are."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = _rand(g, (2, 4, 300, 64), torch.bfloat16, cuda).transpose(1, 2)
    k = _rand(g, (2, 2, 300, 64), torch.bfloat16, cuda).transpose(1, 2)
    v = _rand(g, (2, 2, 300, 64), torch.bfloat16, cuda).transpose(1, 2)
    assert q.stride(2) > q.stride(1)
    _wgmma_case(cuda, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur_len", [1, 63, 128])
@pytest.mark.parametrize("b,h,kh,hd", [(2, 4, 2, 16), (1, 8, 1, 64), (2, 16, 8, 128),
                                       (2, 8, 8, 112), (1, 8, 2, 112)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("cur_len", [1, 63, 128, 129, 777, 1032])
def test_decode_split_matches_plain(cuda, cur_len, group, dtype):
    """The serve run's cache length, cur_len at and across split and block
    step boundaries; B=8, K=8 as qwen3-0.6b, so the planned splits are the
    serve run's."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, t, kh, hd = 8, 1032, 8, 128
    q = _rand(g, (b, 1, kh * group, hd), dtype, cuda)
    kc = _rand(g, (b, t, kh, hd), dtype, cuda)
    vc = _rand(g, (b, t, kh, hd), dtype, cuda)
    before = decode_attn.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, cur_len)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    n_split, rows = decode_attn.decode_attention.last_split
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(hd, q.element_size(), group)
    assert (n_split, rows) == decode_attn.plan_splits(cur_len, b, kh, sm, step)
    ref = decode_attention_ref(q, kc, vc, cur_len)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur_len", [1, 63, 64, 65, 1001, 1032])
def test_decode_split_hd112_matches_plain(cuda, cur_len, dtype):
    """zamba2-7b's decode shape (B=8, T=1032, 32 q and kv heads of 112):
    the hd-128 lane mapping with its last lanes masked, split as the
    planner says for the step of hd 128."""
    g = torch.Generator(device=cuda).manual_seed(9)
    b, t, h, hd = 8, 1032, 32, 112
    q = _rand(g, (b, 1, h, hd), dtype, cuda)
    kc = _rand(g, (b, t, h, hd), dtype, cuda)
    vc = _rand(g, (b, t, h, hd), dtype, cuda)
    out = ops.decode_attention(q, kc, vc, cur_len)
    torch.cuda.synchronize()
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(hd, q.element_size(), 1)
    assert step == decode_attn.rows_per_step(128, q.element_size(), 1)
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        cur_len, b, h, sm, step)
    assert out.shape == q.shape
    ref = decode_attention_ref(q, kc, vc, cur_len)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("b,t,cur_len", [(2, 128, 1), (2, 128, 77), (4, 516, 516),
                                         (8, 1032, 1032), (8, 1032, 129)])
def test_decode_hd256_matches_plain(cuda, b, t, cur_len, group, dtype, partial):
    """head_dim 256 (gemma-2b's 8 q heads on 1 kv head, and group 1): bf16
    rows one vector a lane, fp32 rows two; at group 8 the block's shared
    memory is dynamic (64 KB). The normalised form against
    ``decode_attention_ref``, the block form's o (fp32) and lse against its
    plain version; a rank's block of serve_mesh (4, 516) and the one-card
    serve shape (8, 1032) among the shapes, split as the planner says."""
    g = torch.Generator(device=cuda).manual_seed(11)
    kh, hd = 1 if group == 8 else 4, 256
    q = _rand(g, (b, 1, kh * group, hd), dtype, cuda)
    kc = _rand(g, (b, t, kh, hd), dtype, cuda)
    vc = _rand(g, (b, t, kh, hd), dtype, cuda)
    before = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(q, kc, vc, cur_len, partial=partial)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(hd, q.element_size(), group)
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        cur_len, b, kh, sm, step)
    ref = decode_attention_ref(q, kc, vc, cur_len, partial=partial)
    if partial:
        assert out[0].dtype == torch.float32 and out[1].shape == (b, kh * group)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **_tol(dtype))
    else:
        assert out.dtype == dtype
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   **_tol(dtype))


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("b,kh,t,cur_len", [(2, 2, 128, 1), (2, 2, 128, 77), (1, 8, 300, 129),
                                            (8, 8, 2056, 2056), (8, 8, 2056, 1025)])
def test_decode_group6_matches_plain(cuda, b, kh, t, cur_len, hd, dtype, partial):
    """6 q heads per kv head (internvl2-26b's 48/8, and a 12/2 smoke):
    two rows in flight a lane; at hd 256 the block's shared memory is
    dynamic (49,536 B); the merge grid's kv head h // 6 and member h % 6.
    Both forms against their plain versions, split as the planner says;
    the VLM serve's caches (8, 2056, 8, hd) among the shapes. Each kv
    head's values carry their own offset, so that a misread head shows."""
    g = torch.Generator(device=cuda).manual_seed(14)
    q = _rand(g, (b, 1, kh * 6, hd), dtype, cuda)
    kc = _rand(g, (b, t, kh, hd), dtype, cuda)
    vc = (_rand(g, (b, t, kh, hd), torch.float32, cuda)
          + torch.arange(kh, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    before = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(q, kc, vc, cur_len, partial=partial)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(hd, q.element_size(), 6)
    assert step == decode_attn.rows_per_step(hd, q.element_size(), 8)   # 2 rows in flight
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        cur_len, b, kh, sm, step)
    ref = decode_attention_ref(q, kc, vc, cur_len, partial=partial)
    if partial:
        assert out[0].dtype == torch.float32 and out[1].shape == (b, kh * 6)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **_tol(dtype))
    else:
        assert out.dtype == dtype
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_group6_blocks_of_a_vlm_mesh_rank(cuda, dtype):
    """Decode's block form at group 6 on a rank's block of internvl2-26b's
    cache on (data 2, model 2): q (4, 1, 48, 128) gathered over "model",
    blocks (4, 1028, 8, 128) of a 2,056-position cache, the first full
    (cur_len 1,028: all patches after the prefill of 1,024 patches and
    1,000 tokens) and the second part-filled (cur_len 996). Each block's o
    and lse against its plain version; the two merged (``merge_partials``)
    against the whole cache at cur_len 2,024."""
    from repro_torch.models.attention import merge_partials
    g = torch.Generator(device=cuda).manual_seed(20)
    b, t, kh, hd = 4, 1028, 8, 128
    q = _rand(g, (b, 1, kh * 6, hd), dtype, cuda)
    kc = _rand(g, (b, 2 * t, kh, hd), dtype, cuda)
    vc = (_rand(g, (b, 2 * t, kh, hd), torch.float32, cuda)
          + torch.arange(kh, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(hd, q.element_size(), 6)
    parts = []
    for i, cur_len in enumerate((1028, 996)):
        block = slice(i * t, (i + 1) * t)
        kb, vb = kc[:, block].contiguous(), vc[:, block].contiguous()
        before = decode_attn.decode_attention.launches
        out = ops.decode_attention_partial(q, kb, vb, cur_len)
        torch.cuda.synchronize()
        assert decode_attn.decode_attention.launches == before + 1
        assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
            cur_len, b, kh, sm, step)
        ref = decode_attention_ref(q, kb, vb, cur_len, partial=True)
        assert out[0].dtype == torch.float32 and out[1].shape == (b, kh * 6)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **_tol(dtype))
        parts.append(out)
    merged = merge_partials(torch.stack([o[:, 0] for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]))
    whole = decode_attention_ref(q, kc, vc, 1028 + 996)[:, 0]
    np.testing.assert_allclose(merged.cpu().numpy(), whole.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd", [(8, 1, 256), (48, 8, 128)], ids=["g8_hd256", "g6_hd128"])
def test_decode_block_with_no_position_launches_nothing(cuda, h, kh, hd, dtype):
    """A rank whose cache block holds no position below the query's
    (cur_len 0): ``ops.decode_attention_partial`` gives o = 0 and lse =
    -inf without a launch, and the merge weighs it 0; blocks split at a
    position give the whole cache's attention. gemma-2b's 8 q heads on 1
    kv head of 256, and internvl2-26b's 48 on 8 of 128 (group 6)."""
    from repro_torch.models.attention import merge_partials
    g = torch.Generator(device=cuda).manual_seed(12)
    q = _rand(g, (4, 1, h, hd), dtype, cuda)
    kc = _rand(g, (4, 1032, kh, hd), dtype, cuda)
    vc = _rand(g, (4, 1032, kh, hd), dtype, cuda)
    before = decode_attn.decode_attention.launches
    o, lse = ops.decode_attention_partial(q, kc[:, 516:], vc[:, 516:], 0)
    assert decode_attn.decode_attention.launches == before
    assert (o == 0).all() and torch.isneginf(lse).all() and o.dtype == torch.float32
    o0, lse0 = ops.decode_attention_partial(q, kc[:, :516], vc[:, :516], 300)
    assert decode_attn.decode_attention.launches == before + 1
    merged = merge_partials(torch.stack([o0[:, 0], o[:, 0]]), torch.stack([lse0, lse]))
    whole = ops.decode_attention(q, kc, vc, 300)
    np.testing.assert_allclose(merged.to(dtype).float().cpu().numpy(),
                               whole[:, 0].float().cpu().numpy(), **_tol(dtype))
    o1, lse1 = ops.decode_attention_partial(q, kc[:, 516:], vc[:, 516:], 400)
    o0, lse0 = ops.decode_attention_partial(q, kc[:, :516], vc[:, :516], 516)
    merged = merge_partials(torch.stack([o0[:, 0], o1[:, 0]]), torch.stack([lse0, lse1]))
    whole = ops.decode_attention(q, kc, vc, 916)
    np.testing.assert_allclose(merged.to(dtype).float().cpu().numpy(),
                               whole[:, 0].float().cpu().numpy(), **_tol(dtype))


def test_flash_wgmma_refuses_what_it_does_not_take(cuda):
    """The tensor-core route refuses, and never falls back to the fp32
    kernel or the plain version."""
    routes = flash_attention.flash_attention.routes
    before = dict(routes)
    q = torch.zeros(1, 8, 4, 24, device=cuda, dtype=torch.bfloat16)   # head_dim 24
    with pytest.raises(ValueError, match="wgmma"):
        flash_attention.flash_attention(q, q, q)
    # more 128-row q tiles than the grid's second axis holds (a stride-0 view)
    big = torch.zeros(1, 1, 2, 16, device=cuda, dtype=torch.bfloat16).expand(
        1, 128 * 65535 + 1, 2, 16)
    with pytest.raises(ValueError, match="wgmma"):
        flash_attention.flash_attention(big, big[:, :8], big[:, :8])
    q = torch.zeros(1, 8, 4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                                     # mixed dtypes
        flash_attention.flash_attention(q, q.float(), q.float())
    with pytest.raises(ValueError):                                     # fp16
        flash_attention.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                                     # misaligned view
        flash_attention.flash_attention(q[..., 1:9], q[..., 1:9], q[..., 1:9])
    assert routes == before


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
    q, kc = torch.zeros(1, 1, 8, 96, device=cuda), torch.zeros(1, 8, 1, 96, device=cuda)
    launches = decode_attn.decode_attention.launches
    with pytest.raises(ValueError, match="hd=96"):                  # neither kernel takes 96
        decode_attn.decode_attention(q, kc, kc, 4)
    with pytest.raises(ValueError, match="hd=96"):
        decode_attn.decode_attention(q, kc, kc, 4, partial=True)
    # 3 q heads per kv head: a group the kernel is not built for
    q, kc = torch.zeros(1, 1, 6, 16, device=cuda), torch.zeros(1, 8, 2, 16, device=cuda)
    assert 3 not in decode_attn.GROUPS
    for partial in (False, True):
        with pytest.raises(ValueError, match="H=6, K=2"):
            decode_attn.decode_attention(q, kc, kc, 4, partial=partial)
    assert decode_attn.decode_attention.launches == launches


def _ssd_args(seed, b, s, h, p, n, dtype, device):
    """x, dt (post-softplus), a (< 0), B, C: the distributions of
    tests/test_kernels.py; x, B, C in ``dtype``, dt and a fp32."""
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.1, size=(b, s, h)),
            -rng.uniform(0.5, 2.0, size=(h,)), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, s, n)))
    return [torch.from_numpy(np.asarray(v, np.float32)).to(device).to(
        torch.float32 if i in (1, 2) else dtype) for i, v in enumerate(arrs)]


def _ssd_case(args, chunk, initial_state=None):
    """One ``ops.ssd`` call on the card against ``ssd_chunked``: y at the
    dtype's tolerance, the final state at 1e-3 (tests/test_kernels.py); one
    launch, on the dtype's route (``wgmma`` for bf16, ``fp32``)."""
    dtype = args[0].dtype
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    launches, routes = ssd.ssd.launches, dict(ssd.ssd.routes)
    y, final = ops.ssd(*args, chunk=chunk, initial_state=initial_state)
    torch.cuda.synchronize()
    assert ssd.ssd.launches == launches + 1
    assert ssd.ssd.routes == {**routes, route: routes[route] + 1}
    y_ref, final_ref = ssd_ref(*args, chunk=chunk, initial_state=initial_state)
    assert y.shape == y_ref.shape and y.dtype == dtype and final.dtype == torch.float32
    np.testing.assert_allclose(y.float().cpu().numpy(), y_ref.float().cpu().numpy(),
                               **_tol(dtype))
    np.testing.assert_allclose(final.cpu().numpy(), final_ref.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 8, 16, 32, 16), (1, 128, 8, 32, 64, 32), (2, 48, 16, 16, 16, 16),
    (2, 50, 16, 16, 16, 16), (2, 7, 4, 16, 16, 16), (1, 200, 20, 128, 32, 64),
    (1, 300, 80, 64, 128, 256)])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, chunk, dtype):
    """fp32: the CUDA-core kernel's three outputs against
    ``ssd_intra_chunk_ref`` (2e-5: the same inputs, another summation order;
    states at 1e-3 as tests/test_kernels.py), then the full ``ops.ssd``.
    bf16: the full ``ops.ssd`` on the tensor-core route, which writes no
    intra-chunk term of its own, y at 2e-2 and the final state at 1e-3
    against ``ssd_chunked``. Ragged S (50, 7, 200, 300), heads not a
    multiple of the fp32 kernel's 16-head tile (20), P 16 to 128."""
    args = _ssd_args(2, b, s, h, p, n, dtype, cuda)
    if dtype == torch.float32:
        before = ssd.ssd_intra_chunk.launches
        y_intra, states, decay = ssd.ssd_intra_chunk(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd.ssd_intra_chunk.launches == before + 1
        want = ssd_intra_chunk_ref(*args, chunk=chunk)
        for got, ref, tol in zip((y_intra, states, decay), want, (2e-5, 1e-3, 2e-5)):
            assert got.shape == ref.shape and got.dtype == torch.float32
            np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=tol, atol=tol)
    _ssd_case(args, chunk)


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 300, 5, 64, 128, 256), (1, 1000, 3, 128, 64, 256), (3, 65, 1, 32, 40, 32),
    (1, 129, 2, 16, 128, 128)])
def test_ssd_wgmma_matches_plain(cuda, b, s, h, p, n, chunk, initial):
    """The tensor-core route with a carried-in state or none: an odd head
    count (the last block's second warpgroup has no head), N padded to the
    64-row state tile (40), the largest state at P = 128 (N = 64), S across
    the 64-row step."""
    args = _ssd_args(5, b, s, h, p, n, torch.bfloat16, cuda)
    init = None
    if initial:
        init = torch.from_numpy(np.random.default_rng(6).normal(
            size=(b, h, n, p)).astype(np.float32)).to(cuda)
    _ssd_case(args, chunk, init)


def test_ssd_wgmma_refuses_what_it_does_not_take(cuda):
    """The tensor-core route refuses states that do not fit its registers
    and malformed initial states; the fp32 kernel refuses bf16; neither
    falls back."""
    launches, routes = ssd.ssd.launches, dict(ssd.ssd.routes)
    intra = ssd.ssd_intra_chunk.launches
    with pytest.raises(ValueError, match="wgmma"):               # N > 128
        ssd.ssd(*_ssd_args(7, 1, 16, 2, 16, 136, torch.bfloat16, cuda), chunk=8)
    with pytest.raises(ValueError, match="wgmma"):               # N > 64 at P = 128
        ssd.ssd(*_ssd_args(7, 1, 16, 2, 128, 72, torch.bfloat16, cuda), chunk=8)
    args = _ssd_args(7, 1, 16, 2, 16, 16, torch.bfloat16, cuda)
    for init in (torch.zeros(1, 2, 16, 16, device=cuda, dtype=torch.bfloat16),   # dtype
                 torch.zeros(1, 2, 8, 16, device=cuda),                          # shape
                 torch.zeros(1, 2, 16, 16)):                                     # device
        with pytest.raises(ValueError, match="initial_state"):
            ssd.ssd(*args, chunk=8, initial_state=init)
    with pytest.raises(ValueError, match="fp32"):                # bf16 into the fp32 kernel
        ssd.ssd_intra_chunk(*args, chunk=8)
    assert ssd.ssd.launches == launches and ssd.ssd.routes == routes
    assert ssd.ssd_intra_chunk.launches == intra


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, a, bm, cm = _ssd_args(3, 1, 16, 4, 16, 16, torch.float32, cuda)
    before = ssd.ssd_intra_chunk.launches
    with pytest.raises(ValueError):                             # chunk > 256
        ssd.ssd_intra_chunk(*_ssd_args(4, 1, 520, 4, 16, 16, torch.float32, cuda), chunk=512)
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk(x[..., :8].contiguous(), dt, a, bm, cm, chunk=8)   # P = 8
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk(x, dt.bfloat16(), a, bm, cm, chunk=8)  # dt not fp32
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk(x, dt, a, bm.bfloat16(), cm, chunk=8)  # mixed dtypes
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, bm, cm,
                            chunk=8)                                # strided
    with pytest.raises(ValueError):
        ssd.ssd_intra_chunk(x, dt, a, bm[..., :12].contiguous(), cm[..., :12].contiguous(),
                            chunk=8)                                # N % 8 != 0
    assert ssd.ssd_intra_chunk.launches == before


@pytest.mark.parametrize("dtype,shape,chunk,tol", [
    (torch.bfloat16, (2, 130, 4, 64, 64), 64, 2e-2),
    (torch.float32, (2, 100, 4, 16, 32), 32, 1e-4)], ids=["bf16", "fp32"])
def test_ssd_function_grads_match_plain(cuda, dtype, shape, chunk, tol):
    """``SSD`` on the card (the kernel forward, the ``ssd_chunked``
    recompute backward) against autograd through ``ssd_chunked``: y, the
    final state and the gradients of x, dt, a, B and C."""
    b, s, h, p, n = shape
    args = _ssd_args(8, b, s, h, p, n, dtype, cuda)
    g = np.random.default_rng(9)
    gy = torch.from_numpy(g.normal(size=(b, s, h, p)).astype(np.float32)).to(cuda).to(dtype)
    gf = torch.from_numpy(g.normal(size=(b, h, n, p)).astype(np.float32)).to(cuda)
    runs = []
    for fn in (lambda *t: ssd.SSD.apply(*t, chunk, None),
               lambda *t: ssd_ref(*t, chunk=chunk)):
        leaves = [t.clone().requires_grad_() for t in args]
        launches = ssd.ssd.launches
        y, final = fn(*leaves)
        torch.autograd.backward((y, final), (gy, gf))
        torch.cuda.synchronize()
        runs.append(([y.detach(), final.detach()] + [t.grad for t in leaves],
                     ssd.ssd.launches - launches))
    (got, n_kernel), (want, n_plain) = runs
    assert (n_kernel, n_plain) == (1, 0)
    for name, a_, b_ in zip(("y", "final", "x", "dt", "a", "b", "c"), got, want):
        assert a_.dtype == b_.dtype and a_.shape == b_.shape, name
        np.testing.assert_allclose(a_.float().cpu().numpy(), b_.float().cpu().numpy(),
                                   rtol=tol, atol=tol if name != "final" else 1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_ssd_has_a_gradient_on_the_card(cuda, dtype):
    """An ``ops.ssd`` output whose inputs require grad carries a
    ``grad_fn`` on CUDA (the ctypes kernel's own outputs have none), and
    the gradient reaches x, dt, a, B and C."""
    args = [t.requires_grad_() for t in _ssd_args(10, 1, 70, 2, 16, 16, dtype, cuda)]
    y, final = ops.ssd(*args, chunk=32)
    assert y.grad_fn is not None and final.grad_fn is not None
    y.float().square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in args)
    with torch.no_grad():
        assert ops.ssd(*args, chunk=32)[0].grad_fn is None


def test_vlm_on_the_card_matches_the_cpu(cuda):
    """A VLM at group 6 (12 q / 2 kv heads of 64, 2 layers, 8 patch tokens,
    fp32): prefill behind random patch embeddings, 8 decode steps (both
    sides take the CPU's greedy token), the loss on the text positions and
    every gradient, on the card (flash and decode kernels, fp32 routes)
    against the same weights on the CPU, at 2e-4."""
    import dataclasses

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("internvl2-26b")), num_heads=12,
                              num_kv_heads=2, head_dim=64, d_model=96, dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(16)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 21)))
    patches = torch.from_numpy(rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32))
    launches = (flash_attention.flash_attention.launches, decode_attn.decode_attention.launches)
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = model.device
        logits, cache = build_prefill_step(model)(tokens[:, :12].to(dev), 8 + 12 + 9,
                                                  patches.to(dev))
        assert cache["index"] == 8 + 12
        steps = [logits.cpu()]
        caches = [cache["k"].cpu().clone(), cache["v"].cpu().clone()]   # decode writes in place
        decode = build_decode_step(model)
        for step in range(8):
            tok = (outs["cpu"] if name == "cuda" else steps)[step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            steps.append(logits.cpu())
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": tokens.to(dev), "patch_embeds": patches.to(dev)})
        loss.backward()
        outs[name] = steps + caches + [loss.detach().cpu()] + [
            p.grad.cpu() for p in model.parameters()]
    assert (flash_attention.flash_attention.launches - launches[0],
            decode_attn.decode_attention.launches - launches[1]) == (2 * 2, 2 * 8)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [1500, 16])
def test_flash_noncausal_hd64_at_whisper_shapes(cuda, sq, dtype):
    """whisper-small's non-causal attention at head_dim 64, 12 heads (MHA):
    the encoder's q/k/v (2, 1500, 12, 64) (11 full 128-row q tiles and a
    ragged one of 92, ragged kv tiles) and the cross-attention's q (2, 16,
    12, 64) against k/v (2, 1500, 12, 64); the forward on the kernel and
    the gradient into q, k and v under ``FlashAttention`` against autograd
    through the plain version."""
    g = torch.Generator(device=cuda).manual_seed(17)
    q = _rand(g, (2, sq, 12, 64), dtype, cuda).requires_grad_()
    k = _rand(g, (2, 1500, 12, 64), dtype, cuda).requires_grad_()
    v = _rand(g, (2, 1500, 12, 64), dtype, cuda).requires_grad_()
    dout = _rand(g, (2, sq, 12, 64), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    grads = torch.autograd.grad(out, (q, k, v), dout)
    ref = ops.flash_attention_plain(q, k, v, causal=False)
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)
    assert out.shape == q.shape and out.dtype == dtype
    for got, want in zip((out,) + grads, (ref,) + ref_grads):
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   want.detach().float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [2, 8])
def test_decode_against_the_whisper_cross_cache(cuda, b, dtype, partial):
    """One query a row against every one of the cross cache's 1,500 frames
    (group 1, head_dim 64, 12 heads, cur_len = the cache's length), at 8
    rows (the serve run's 96 (batch x head) rows, its split plan) and 2."""
    g = torch.Generator(device=cuda).manual_seed(18)
    q = _rand(g, (b, 1, 12, 64), dtype, cuda)
    kc = _rand(g, (b, 1500, 12, 64), dtype, cuda)
    vc = _rand(g, (b, 1500, 12, 64), dtype, cuda)
    before = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(q, kc, vc, 1500, partial=partial)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        1500, b, 12, sm, decode_attn.rows_per_step(64, q.element_size(), 1))
    ref = decode_attention_ref(q, kc, vc, 1500, partial=partial)
    for got, want in zip(out if partial else (out,), ref if partial else (ref,)):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **_tol(dtype))


def test_encdec_on_the_card_matches_the_cpu(cuda):
    """The smoke whisper-small at head_dim 64 (12 heads, d_model 96, 2 + 2
    layers, 40 frames, fp32): prefill of random frames and a prompt, 8
    decode steps (both sides take the CPU's greedy token), the self and
    cross caches, the loss and every gradient, on the card (flash and
    decode kernels, fp32 routes) against the same weights on the CPU, at
    2e-4."""
    import dataclasses

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model
    from repro_torch.train.serve import build_decode_step, build_prefill_step
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("whisper-small")), num_heads=12,
                              num_kv_heads=12, head_dim=64, d_model=96, encoder_seq=40,
                              dtype="float32")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(19)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 21)))
    frames = torch.from_numpy(rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32))
    launches = (flash_attention.flash_attention.launches, decode_attn.decode_attention.launches)
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = model.device
        logits, cache = build_prefill_step(model)(tokens[:, :12].to(dev), 12 + 9, None,
                                                  frames.to(dev))
        assert cache["index"] == 12
        steps = [logits.cpu()]
        # decode writes the self cache in place
        caches = [cache[key].cpu().clone() for key in ("k", "v", "cross_k", "cross_v")]
        decode = build_decode_step(model)
        for step in range(8):
            tok = (outs["cpu"] if name == "cuda" else steps)[step].argmax(-1)
            logits, cache = decode(cache, tok.to(dev))
            steps.append(logits.cpu())
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": tokens.to(dev), "frames": frames.to(dev)})
        loss.backward()
        outs[name] = steps + caches + [cache["k"].cpu(), loss.detach().cpu()] + [
            p.grad.cpu() for p in model.parameters()]
    # flash: 2 encoder + 2 x 2 decoder layers in the prefill and again in the
    # loss; decode: 2 layers x 2 attentions x 8 steps
    assert (flash_attention.flash_attention.launches - launches[0],
            decode_attn.decode_attention.launches - launches[1]) == (2 * 6, 2 * 2 * 8)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_blocks_of_an_encdec_mesh_rank(cuda, dtype):
    """Decode's block form at head_dim 64 and group 1 on a rank's block of
    whisper-small's cross cache on (data 2, model 2): q (4, 1, 12, 64)
    gathered over "model", blocks (4, 750, 12, 64) of the 1,500 frames,
    every position valid (cur_len 750). Each block's o and lse against its
    plain version; the two merged (``merge_partials``) against the whole
    cache at cur_len 1,500."""
    from repro_torch.models.attention import merge_partials
    g = torch.Generator(device=cuda).manual_seed(21)
    b, t, h, hd = 4, 750, 12, 64
    q = _rand(g, (b, 1, h, hd), dtype, cuda)
    kc = _rand(g, (b, 2 * t, h, hd), dtype, cuda)
    vc = (_rand(g, (b, 2 * t, h, hd), torch.float32, cuda)
          + torch.arange(h, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(hd, q.element_size(), 1)
    parts = []
    for i in range(2):
        block = slice(i * t, (i + 1) * t)
        kb, vb = kc[:, block].contiguous(), vc[:, block].contiguous()
        before = decode_attn.decode_attention.launches
        out = ops.decode_attention_partial(q, kb, vb, t)
        torch.cuda.synchronize()
        assert decode_attn.decode_attention.launches == before + 1
        assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
            t, b, h, sm, step)
        ref = decode_attention_ref(q, kb, vb, t, partial=True)
        assert out[0].dtype == torch.float32 and out[1].shape == (b, h)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **_tol(dtype))
        parts.append(out)
    merged = merge_partials(torch.stack([o[:, 0] for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]))
    whole = decode_attention_ref(q, kc, vc, 2 * t)[:, 0]
    np.testing.assert_allclose(merged.cpu().numpy(), whole.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_noncausal_at_an_encdec_mesh_rank(cuda, dtype):
    """A rank's encoder attention in whisper-small's sharded step on (data
    2, model 2): its 6 heads of 64 over 4 rows of 1,500 frames, non-causal;
    the forward on the kernel and the gradient into q, k and v under
    ``FlashAttention`` against autograd through the plain version. Each
    head's values carry their own offset."""
    g = torch.Generator(device=cuda).manual_seed(22)
    b, s, h = 4, 1500, 6
    q = _rand(g, (b, s, h, 64), dtype, cuda).requires_grad_()
    k = _rand(g, (b, s, h, 64), dtype, cuda).requires_grad_()
    v = (_rand(g, (b, s, h, 64), torch.float32, cuda)
         + torch.arange(h, device=cuda, dtype=torch.float32)[:, None]).to(dtype).requires_grad_()
    dout = _rand(g, (b, s, h, 64), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    grads = torch.autograd.grad(out, (q, k, v), dout)
    ref = ops.flash_attention_plain(q, k, v, causal=False)
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)
    assert out.shape == q.shape and out.dtype == dtype
    for got, want in zip((out,) + grads, (ref,) + ref_grads):
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   want.detach().float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_the_qwen3_moe_30b_serve_shape(cuda, dtype):
    """The prefill's attention: q (8, 1000, 32, 128), k/v (8, 1000, 4, 128),
    causal, on the wrapper's route for the dtype."""
    g = torch.Generator(device=cuda).manual_seed(30)
    q = _rand(g, (8, 1000, 32, 128), dtype, cuda)
    k = _rand(g, (8, 1000, 4, 128), dtype, cuda)
    v = _rand(g, (8, 1000, 4, 128), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    ref = ops.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur_len", [1001, 1032])
def test_decode_at_the_qwen3_moe_30b_serve_shape(cuda, cur_len, dtype):
    """A decode step's attention: q (8, 1, 32, 128) against caches (8, 1032,
    4, 128) at the first and last step's length, split as the planner says
    for group 8."""
    g = torch.Generator(device=cuda).manual_seed(31)
    q = _rand(g, (8, 1, 32, 128), dtype, cuda)
    kc = _rand(g, (8, 1032, 4, 128), dtype, cuda)
    vc = _rand(g, (8, 1032, 4, 128), dtype, cuda)
    before = decode_attn.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, cur_len)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(128, q.element_size(), 8)
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        cur_len, 8, 4, sm, step)
    ref = decode_attention_ref(q, kc, vc, cur_len)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_the_nemotron_4_15b_serve_shape(cuda, dtype):
    """nemotron-4-15b's prefill attention: q (8, 1000, 48, 128), k/v (8,
    1000, 8, 128) (group 6), causal, on the wrapper's route for the dtype."""
    g = torch.Generator(device=cuda).manual_seed(40)
    q = _rand(g, (8, 1000, 48, 128), dtype, cuda)
    k = _rand(g, (8, 1000, 8, 128), dtype, cuda)
    v = _rand(g, (8, 1000, 8, 128), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    ref = ops.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur_len", [1001, 1032])
def test_decode_at_the_nemotron_4_15b_serve_shape(cuda, cur_len, dtype):
    """nemotron-4-15b's decode step: q (8, 1, 48, 128) against caches (8,
    1032, 8, 128) at the first and last step's length, split as the planner
    says for group 6."""
    g = torch.Generator(device=cuda).manual_seed(41)
    q = _rand(g, (8, 1, 48, 128), dtype, cuda)
    kc = _rand(g, (8, 1032, 8, 128), dtype, cuda)
    vc = _rand(g, (8, 1032, 8, 128), dtype, cuda)
    before = decode_attn.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, cur_len)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(128, q.element_size(), 6)
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        cur_len, 8, 8, sm, step)
    ref = decode_attention_ref(q, kc, vc, cur_len)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


# gpt2-2.7b's attention: 32 heads of 80 (MHA), the serve shape (8 prompts of
# 1,000 tokens, a cache of 1,032) and the training step's (8 x 1,024)
GPT2_FLASH = {"serve": (8, 1000, 32, 80), "train": (8, 1024, 32, 80)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", sorted(GPT2_FLASH))
def test_flash_hd80_at_the_gpt2_shapes(cuda, shape, causal, dtype):
    """head_dim 80 on the hd-128 tiles (columns 80-127 zero, never
    stored): the forward on the wrapper's route for the dtype and the
    gradients into q, k and v under ``FlashAttention`` against autograd
    through the plain version. Each head's values carry their own offset,
    so that a misread head or column shows."""
    g = torch.Generator(device=cuda).manual_seed(50)
    b, s, h, hd = GPT2_FLASH[shape]
    q = _rand(g, (b, s, h, hd), dtype, cuda).requires_grad_()
    k = _rand(g, (b, s, h, hd), dtype, cuda).requires_grad_()
    v = (_rand(g, (b, s, h, hd), torch.float32, cuda)
         + torch.arange(h, device=cuda, dtype=torch.float32)[:, None]).to(dtype).requires_grad_()
    dout = _rand(g, (b, s, h, hd), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    grads = torch.autograd.grad(out, (q, k, v), dout)
    ref = ops.flash_attention_plain(q, k, v, causal=causal)
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)
    for got, want in zip((out,) + grads, (ref,) + ref_grads):
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   want.detach().float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kh,group,t,cur_len", [
    (8, 32, 1, 1032, 1), (8, 32, 1, 1032, 129), (8, 32, 1, 1032, 1001), (8, 32, 1, 1032, 1032),
    (2, 2, 8, 128, 77), (1, 4, 4, 300, 129), (2, 2, 6, 200, 200)])
def test_decode_hd80_matches_plain(cuda, b, kh, group, t, cur_len, dtype, partial):
    """head_dim 80 on the hd-128 lane mapping (10 of 16 bf16 lanes live, 20
    of 32 in fp32), both forms against their plain versions, split as the
    planner says for the step of hd 128: gpt2-2.7b's serve shape (8, 1032,
    32, 80) at group 1, and small shapes at groups 4, 6 and 8."""
    g = torch.Generator(device=cuda).manual_seed(51)
    hd = 80
    q = _rand(g, (b, 1, kh * group, hd), dtype, cuda)
    kc = _rand(g, (b, t, kh, hd), dtype, cuda)
    vc = (_rand(g, (b, t, kh, hd), torch.float32, cuda)
          + torch.arange(kh, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    before = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(q, kc, vc, cur_len, partial=partial)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(hd, q.element_size(), group)
    assert step == decode_attn.rows_per_step(128, q.element_size(), group)
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        cur_len, b, kh, sm, step)
    ref = decode_attention_ref(q, kc, vc, cur_len, partial=partial)
    if partial:
        assert out[0].dtype == torch.float32 and out[1].shape == (b, kh * group)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **_tol(dtype))
    else:
        assert out.dtype == dtype and out.shape == q.shape
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_hd80_gpt2_blocks_merged_against_the_whole_cache(cuda, dtype):
    """Decode's block form at head_dim 80 on two blocks (8, 516, 32, 80) of
    gpt2-2.7b's 1,032-position cache, the second part-filled (cur_len 400):
    each block's o and lse against its plain version, the two merged
    (``merge_partials``) against the whole cache's normalised attention at
    cur_len 916 on the kernel."""
    from repro_torch.models.attention import merge_partials
    g = torch.Generator(device=cuda).manual_seed(52)
    b, t, h, hd = 8, 516, 32, 80
    q = _rand(g, (b, 1, h, hd), dtype, cuda)
    kc = _rand(g, (b, 2 * t, h, hd), dtype, cuda)
    vc = (_rand(g, (b, 2 * t, h, hd), torch.float32, cuda)
          + torch.arange(h, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    parts = []
    for i, cur_len in enumerate((t, 400)):
        block = slice(i * t, (i + 1) * t)
        kb, vb = kc[:, block].contiguous(), vc[:, block].contiguous()
        before = decode_attn.decode_attention.launches
        out = ops.decode_attention_partial(q, kb, vb, cur_len)
        torch.cuda.synchronize()
        assert decode_attn.decode_attention.launches == before + 1
        ref = decode_attention_ref(q, kb, vb, cur_len, partial=True)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **_tol(dtype))
        parts.append(out)
    merged = merge_partials(torch.stack([o[:, 0] for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]))
    whole = ops.decode_attention(q, kc, vc, t + 400)
    np.testing.assert_allclose(merged.to(dtype).float().cpu().numpy(),
                               whole[:, 0].float().cpu().numpy(), **_tol(dtype))
    np.testing.assert_allclose(merged.cpu().numpy(), decode_attention_ref(
        q, kc, vc, t + 400)[:, 0].float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_the_deepseek_67b_serve_shape(cuda, dtype):
    """deepseek-67b's prefill attention: q (8, 1000, 64, 128), k/v (8,
    1000, 8, 128) (group 8), causal, on the wrapper's route for the dtype."""
    g = torch.Generator(device=cuda).manual_seed(53)
    q = _rand(g, (8, 1000, 64, 128), dtype, cuda)
    k = _rand(g, (8, 1000, 8, 128), dtype, cuda)
    v = _rand(g, (8, 1000, 8, 128), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    ref = ops.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur_len", [1001, 1032])
def test_decode_at_the_deepseek_67b_serve_shape(cuda, cur_len, dtype):
    """deepseek-67b's decode step: q (8, 1, 64, 128) against caches (8,
    1032, 8, 128) at the first and last step's length, split as the
    planner says for group 8."""
    g = torch.Generator(device=cuda).manual_seed(54)
    q = _rand(g, (8, 1, 64, 128), dtype, cuda)
    kc = _rand(g, (8, 1032, 8, 128), dtype, cuda)
    vc = _rand(g, (8, 1032, 8, 128), dtype, cuda)
    before = decode_attn.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, cur_len)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(128, q.element_size(), 8)
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        cur_len, 8, 8, sm, step)
    ref = decode_attention_ref(q, kc, vc, cur_len)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


# the paper's LLaMA serves (8 prompts of 1,000 tokens, a cache of 1,032):
# llama3-8b's 32 q heads on 8 kv heads of 128 (group 4), llama2-13b's MHA of
# 40 heads of 128; llama3-70b's are deepseek-67b's shapes
LLAMA_HEADS = {"llama3_8b": (32, 8), "llama2_13b": (40, 40)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(LLAMA_HEADS))
def test_flash_at_the_llama_serve_shapes(cuda, arch, dtype):
    """The prefill's attention, q (8, 1000, H, 128) against k/v (8, 1000,
    K, 128), causal, on the wrapper's route for the dtype. Each kv head's
    values carry their own offset, so that a q head reading another group's
    kv head shows."""
    h, kh = LLAMA_HEADS[arch]
    g = torch.Generator(device=cuda).manual_seed(60)
    q = _rand(g, (8, 1000, h, 128), dtype, cuda)
    k = _rand(g, (8, 1000, kh, 128), dtype, cuda)
    v = (_rand(g, (8, 1000, kh, 128), torch.float32, cuda)
         + torch.arange(kh, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    ref = ops.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur_len", [1001, 1032])
@pytest.mark.parametrize("arch", sorted(LLAMA_HEADS))
def test_decode_at_the_llama_serve_shapes(cuda, arch, cur_len, dtype, partial):
    """A decode step's attention, q (8, 1, H, 128) against caches (8, 1032,
    K, 128) at the first and last step's length, in both forms, split as
    the planner says for the group."""
    h, kh = LLAMA_HEADS[arch]
    g = torch.Generator(device=cuda).manual_seed(61)
    q = _rand(g, (8, 1, h, 128), dtype, cuda)
    kc = _rand(g, (8, 1032, kh, 128), dtype, cuda)
    vc = (_rand(g, (8, 1032, kh, 128), torch.float32, cuda)
          + torch.arange(kh, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    before = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(q, kc, vc, cur_len, partial=partial)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(128, q.element_size(), h // kh)
    assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
        cur_len, 8, kh, sm, step)
    ref = decode_attention_ref(q, kc, vc, cur_len, partial=partial)
    if partial:
        assert out[0].dtype == torch.float32 and out[1].shape == (8, h)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **_tol(dtype))
    else:
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_hd80_at_a_gpt2_mesh_rank(cuda, dtype):
    """A rank's attention in gpt2-2.7b's sharded step on (data 2, model 2):
    its 16 of the 32 heads of 80 over 4 rows of 1,024 positions (gathered
    over "model"), causal; the forward on the kernel and the gradient into
    q, k and v under ``FlashAttention`` against autograd through the plain
    version. Each head's values carry their own offset."""
    g = torch.Generator(device=cuda).manual_seed(62)
    b, s, h, hd = 4, 1024, 16, 80
    q = _rand(g, (b, s, h, hd), dtype, cuda).requires_grad_()
    k = _rand(g, (b, s, h, hd), dtype, cuda).requires_grad_()
    v = (_rand(g, (b, s, h, hd), torch.float32, cuda)
         + torch.arange(h, device=cuda, dtype=torch.float32)[:, None]).to(dtype).requires_grad_()
    dout = _rand(g, (b, s, h, hd), dtype, cuda)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    routed = flash_attention.flash_attention.routes[route]
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == routed + 1
    grads = torch.autograd.grad(out, (q, k, v), dout)
    ref = ops.flash_attention_plain(q, k, v, causal=True)
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)
    assert out.shape == q.shape and out.dtype == dtype
    for got, want in zip((out,) + grads, (ref,) + ref_grads):
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   want.detach().float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_hd80_blocks_of_a_gpt2_mesh_rank(cuda, dtype):
    """Decode's block form at head_dim 80 on a rank's block of gpt2-2.7b's
    cache on (data 2, model 2): q (4, 1, 32, 80) gathered over "model",
    blocks (4, 516, 32, 80) of the 1,032 positions, rank 0's full (516)
    and rank 1's at the first decode step (486). Each block's o and lse
    against its plain version, split as the planner says; the two merged
    (``merge_partials``) against the whole cache at 1,002 positions, on the
    kernel and on the plain version."""
    from repro_torch.models.attention import merge_partials
    g = torch.Generator(device=cuda).manual_seed(63)
    b, t, h, hd = 4, 516, 32, 80
    q = _rand(g, (b, 1, h, hd), dtype, cuda)
    kc = _rand(g, (b, 2 * t, h, hd), dtype, cuda)
    vc = (_rand(g, (b, 2 * t, h, hd), torch.float32, cuda)
          + torch.arange(h, device=cuda, dtype=torch.float32)[:, None]).to(dtype)
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    step = decode_attn.rows_per_step(hd, q.element_size(), 1)
    parts = []
    for i, cur_len in enumerate((t, 486)):
        block = slice(i * t, (i + 1) * t)
        kb, vb = kc[:, block].contiguous(), vc[:, block].contiguous()
        before = decode_attn.decode_attention.launches
        out = ops.decode_attention_partial(q, kb, vb, cur_len)
        torch.cuda.synchronize()
        assert decode_attn.decode_attention.launches == before + 1
        assert decode_attn.decode_attention.last_split == decode_attn.plan_splits(
            cur_len, b, h, sm, step)
        ref = decode_attention_ref(q, kb, vb, cur_len, partial=True)
        assert out[0].dtype == torch.float32 and out[1].shape == (b, h)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **_tol(dtype))
        parts.append(out)
    merged = merge_partials(torch.stack([o[:, 0] for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]))
    whole = ops.decode_attention(q, kc, vc, t + 486)
    np.testing.assert_allclose(merged.to(dtype).float().cpu().numpy(),
                               whole[:, 0].float().cpu().numpy(), **_tol(dtype))
    np.testing.assert_allclose(merged.cpu().numpy(), decode_attention_ref(
        q, kc, vc, t + 486)[:, 0].float().cpu().numpy(), **_tol(dtype))


def test_analysis_mode_on_the_card_raises(cuda):
    """A smoke model on the card under analysis mode raises at its first
    kernel call site (the plain forms are taken on CPU tensors only), and
    outside it runs through the kernels."""
    import dataclasses

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import build_model, modes
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("qwen3-0.6b")), dtype="float32")
    model = build_model(cfg, device=cuda)
    model.load_state_dict(build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict())
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": tokens.to(cuda)}
    with torch.no_grad():
        with modes.analysis_mode(), pytest.raises(RuntimeError, match="CUDA tensor"):
            model.loss(batch)
        n = flash_attention.flash_attention.launches
        assert torch.isfinite(model.loss(batch)[0])
    assert flash_attention.flash_attention.launches > n
