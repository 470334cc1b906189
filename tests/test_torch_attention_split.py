"""The algebra of the redesigned attention kernels, on the CPU, against the
reference: the decode split planner (every cache position in exactly one
non-empty split), a numpy emulation of the split-then-merge decode, and a
numpy emulation of the tensor-core flash tiling (probabilities rounded to
bf16 before P.V), each held against the Pallas kernels in interpret mode at
the bf16 tolerance of tests/test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import decode_attn as tdec

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round to bf16 (nearest even, as the kernels' conversions) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [_bf16(rng.normal(size=s)) for s in shapes]


# --------------------------------------------------------------------------- #
# split planner
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("batch,kv_heads", [(1, 1), (1, 8), (2, 4), (8, 8), (64, 8)])
@pytest.mark.parametrize("step", [64, 128, 1024])
def test_plan_splits_covers_every_position_once(sm_count, batch, kv_heads, step):
    want = -(-tdec.BLOCKS_PER_SM * sm_count // (batch * kv_heads))
    for cur_len in range(1, 4097):
        n_split, rows = tdec.plan_splits(cur_len, batch, kv_heads, sm_count, step)
        assert n_split >= 1 and rows >= 1 and rows % step == 0
        starts = np.arange(n_split) * rows
        ends = np.minimum(starts + rows, cur_len)
        assert (ends > starts).all(), (cur_len, n_split, rows)       # no empty split
        assert starts[0] == 0 and ends[-1] == cur_len                # all covered
        assert (starts[1:] == ends[:-1]).all()                       # exactly once
        steps = -(-cur_len // step)
        assert n_split <= max(1, min(want, steps))
        assert 2 * n_split >= min(want, steps)                       # ~the aimed blocks


def test_plan_splits_at_the_serve_shape():
    """qwen3-0.6b decode, B=8, K=8, bf16 hd 128 on 132 SMs: one split up to
    one block step (64 rows), a split boundary past it, about 2 blocks per
    SM at the full cache."""
    step = tdec.rows_per_step(128, 2, 2)
    assert step == 64
    assert tdec.plan_splits(1, 8, 8, 132, step) == (1, 64)
    assert tdec.plan_splits(64, 8, 8, 132, step) == (1, 64)
    assert tdec.plan_splits(65, 8, 8, 132, step) == (2, 64)
    assert tdec.plan_splits(129, 8, 8, 132, step) == (3, 64)
    n_split, rows = tdec.plan_splits(1032, 8, 8, 132, step)
    assert (n_split, rows) == (5, 256) and 8 * 8 * n_split >= 2 * 132


def test_head_dims_flash_takes_256_and_decode_does_not():
    """Flash has an hd-256 instantiation on both routes, and so has decode
    now (gemma-2b serves): the two kernels take the same head_dims, 80
    (gpt2-2.7b's) in neither."""
    from repro_torch.kernels import flash_attention as tflash
    assert 256 in tflash.HEAD_DIMS and 256 in tdec.HEAD_DIMS
    assert set(tdec.HEAD_DIMS) == set(tflash.HEAD_DIMS) and 80 not in tdec.HEAD_DIMS


def test_plan_splits_refuses_nonsense():
    with pytest.raises(ValueError):
        tdec.plan_splits(0, 8, 8, 132)
    with pytest.raises(ValueError):
        tdec.plan_splits(10, 8, 8, 0)


@pytest.mark.parametrize("hd,itemsize,group,rows", [
    (128, 2, 2, 64), (128, 2, 8, 32), (128, 4, 1, 32), (16, 2, 4, 512), (64, 4, 4, 64),
    (112, 2, 1, 64), (112, 4, 1, 32), (256, 2, 8, 16), (256, 2, 1, 32), (256, 4, 8, 16),
    (256, 4, 4, 32)])
def test_rows_per_step_is_the_kernel_geometry(hd, itemsize, group, rows):
    assert tdec.rows_per_step(hd, itemsize, group) == rows


# --------------------------------------------------------------------------- #
# split-then-merge decode
# --------------------------------------------------------------------------- #
def split_merge_decode(q, k, v, cur_len, n_split, rows):
    """The decode kernel's algebra in fp32: each split's (m, l, acc) over its
    positions, then the max-rescale merge, acc / max(l, 1e-30).
    q: (B, 1, H, hd); caches (B, T, K, hd), fp32 arrays of bf16 values."""
    b, _, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = (q[:, 0] * np.float32(1.0 / np.sqrt(hd))).reshape(b, kh, g, hd)
    parts = []
    for s in range(n_split):
        lo, hi = s * rows, min(cur_len, (s + 1) * rows)
        sc = np.einsum("bkgd,btkd->bkgt", qg, k[:, lo:hi]).astype(np.float32)
        m = sc.max(-1)
        p = np.exp(sc - m[..., None]).astype(np.float32)
        parts.append((m, p.sum(-1), np.einsum("bkgt,btkd->bkgd", p, v[:, lo:hi])))
    mx = np.max([m for m, _, _ in parts], axis=0)
    l_sum = sum(l * np.exp(m - mx) for m, l, _ in parts)
    acc = sum(a * np.exp(m - mx)[..., None] for m, _, a in parts)
    out = acc / np.maximum(l_sum, np.float32(1e-30))[..., None]
    return _bf16(out.reshape(b, 1, h, hd))


@pytest.mark.parametrize("cur_len", [1, 63, 128, 129, 777, 1032])
@pytest.mark.parametrize("h,kh", [(4, 4), (16, 8), (8, 2), (16, 2)])
def test_split_merge_decode_matches_pallas(cur_len, h, kh):
    b, t, hd = 2, 1032, 32
    q, k, v = _inputs(20, [(b, 1, h, hd), (b, t, kh, hd), (b, t, kh, hd)])
    pallas = jops.decode_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                   jnp.asarray(cur_len), bt=t)
    pallas = np.asarray(pallas.astype(jnp.float32))
    # many splits (a small step) and the serve plan (132 SMs, step 64)
    for sm, step in ((132, 16), (132, 64)):
        n_split, rows = tdec.plan_splits(cur_len, b, kh, sm, step)
        out = split_merge_decode(q, k, v, cur_len, n_split, rows)
        np.testing.assert_allclose(out, pallas, **BF16_TOL)


# --------------------------------------------------------------------------- #
# tensor-core flash tiling
# --------------------------------------------------------------------------- #
def wgmma_flash(q, k, v, causal):
    """The tensor-core flash kernel's algebra: 64-row warpgroups, kv tiles
    of 64 rows (hd 128 and 256) or 128 (smaller hd), raw scores masked to -1e30,
    the running max in raw units, p = exp2(s * scale * log2(e) - m * scale
    * log2(e)), fp32 running sums, P rounded to bf16 before P.V, fp32
    accumulation, acc / max(l, 1e-30) rounded to bf16. q (B, Sq, H, hd),
    k/v (B, Skv, K, hd): fp32 arrays of bf16 values."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    bk = 64 if hd >= 128 else 128
    scale = np.float32(1.0 / np.sqrt(hd)) * LOG2E
    out = np.zeros((b, sq, h, hd), np.float32)
    for hh in range(h):
        kv = hh // (h // kh)
        for q0 in range(0, sq, 64):                     # one warpgroup's rows
            qpos = np.arange(q0, min(q0 + 64, sq))
            qt = q[:, qpos, hh]                          # (B, r, hd)
            wg_end = min(skv, q0 + 64) if causal else skv    # keys these rows see
            m = np.full((b, len(qpos)), NEG_INF)
            l_sum = np.zeros((b, len(qpos)), np.float32)
            acc = np.zeros((b, len(qpos), hd), np.float32)
            for kv0 in range(0, wg_end, bk):
                kpos = np.arange(kv0, kv0 + bk)
                ok = kpos[None, :] < skv
                if causal:
                    ok = ok & (kpos[None, :] <= qpos[:, None])
                kt = k[:, np.minimum(kpos, skv - 1), kv]
                vt = v[:, np.minimum(kpos, skv - 1), kv] * (kpos < skv)[None, :, None]
                s = np.einsum("brd,btd->brt", qt, kt).astype(np.float32)
                s = np.where(ok[None], s, NEG_INF)
                m_new = np.maximum(m, s.max(-1))
                corr = np.exp2((m - m_new) * scale)
                p = np.exp2(s * scale - (m_new * scale)[..., None]).astype(np.float32)
                l_sum = l_sum * corr + p.sum(-1)
                acc = acc * corr[..., None] + np.einsum("brt,btd->brd", _bf16(p), vt)
                m = m_new
            out[:, qpos, hh] = acc / np.maximum(l_sum, np.float32(1e-30))[..., None]
    return _bf16(out)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kh,hd", [(128, 4, 2, 16), (256, 2, 1, 32), (64, 4, 4, 64),
                                       (192, 2, 1, 128), (192, 4, 1, 256)])
def test_wgmma_flash_tiling_matches_pallas(s, h, kh, hd, causal):
    b = 2
    q, k, v = _inputs(21, [(b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)])
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    pallas = jops.flash_attention(qj, jattn.repeat_kv(kj, h), jattn.repeat_kv(vj, h),
                                  causal=causal, bq=64, bk=64)
    out = wgmma_flash(q, k, v, causal)
    np.testing.assert_allclose(out, np.asarray(pallas.astype(jnp.float32)), **BF16_TOL)


@pytest.mark.parametrize("s,causal", [(1, True), (100, True), (129, False), (1000, True)])
def test_wgmma_flash_tiling_matches_pallas_on_ragged_lengths(s, causal):
    """Ragged lengths (the Pallas kernel then runs as one tile) and the serve
    run's length with its head_dim: the bf16 rounding of P stays inside the
    tolerance, and is a small share of it."""
    b, h, kh, hd = 1, 2, 1, 128
    q, k, v = _inputs(22, [(b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)])
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    pallas = jops.flash_attention(qj, jattn.repeat_kv(kj, h), jattn.repeat_kv(vj, h),
                                  causal=causal, bq=s, bk=s)
    pallas = np.asarray(pallas.astype(jnp.float32))
    out = wgmma_flash(q, k, v, causal)
    np.testing.assert_allclose(out, pallas, **BF16_TOL)
    assert np.abs(out - pallas).max() <= 0.5 * BF16_TOL["atol"]


# --------------------------------------------------------------------------- #
# the block form: a cache split by sequence, merged across ranks
# --------------------------------------------------------------------------- #
def _decode_case(seed, b, t, h, kh, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((b, 1, h, hd), (b, t, kh, hd), (b, t, kh, hd))]


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                     # the property test below then skips
    given = None


def _blocks_merge_to_the_whole(seed, t, cut_points, cur_len, h, kh):
    """Blocks [c_i, c_{i+1}) of a t-long cache, each run on its first
    clamp(cur_len - c_i, 0, len) positions as a rank does (an empty block
    o = 0, lse = -inf, as ``ops.decode_attention_partial`` gives it without
    running anything), merged: equal to ``decode_attention`` on the whole
    cache at cur_len, in fp32."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import decode_attention, merge_partials
    q, k, v = _decode_case(seed, 2, t, h, kh, 16)
    want = decode_attention(q, k, v, cur_len, h)
    edges = [0] + sorted(cut_points) + [t]
    os, lses = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        cur = min(max(cur_len - lo, 0), hi - lo)
        o, lse = ops.decode_attention_partial(q, k[:, lo:hi], v[:, lo:hi], cur)
        assert o.dtype == torch.float32 and lse.shape == (2, h)
        if cur == 0:
            assert (o == 0).all() and torch.isneginf(lse).all()
        os.append(o[:, 0])
        lses.append(lse)
    got = merge_partials(torch.stack(os), torch.stack(lses))[:, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


if given is not None:
    @settings(max_examples=60, deadline=None)
    @given(t=st.integers(1, 40), data=st.data(), h_kh=st.sampled_from([(4, 4), (8, 1), (4, 2)]),
           seed=st.integers(0, 2 ** 16))
    def test_blocks_of_any_split_merge_to_the_whole_cache(t, data, h_kh, seed):
        """Any split of a cache into contiguous blocks, some of them empty or
        past cur_len: the blocks' partial states merge to the whole-cache
        attention (hypothesis draws the cut points and cur_len)."""
        cuts = data.draw(st.lists(st.integers(0, t), max_size=5), label="cut points")
        cur_len = data.draw(st.integers(1, t), label="cur_len")
        _blocks_merge_to_the_whole(seed, t, cuts, cur_len, *h_kh)
else:
    def test_blocks_of_any_split_merge_to_the_whole_cache():
        pytest.skip("hypothesis not installed")


@pytest.mark.parametrize("t,cuts,cur_len", [(12, [6], 12), (12, [6], 3), (12, [4, 8], 5),
                                            (9, [0, 0, 9], 9), (16, [8], 8)])
def test_blocks_merge_to_the_whole_cache_at_fixed_splits(t, cuts, cur_len):
    """The rank layouts of the serve steps: halves, thirds, empty blocks at
    either end, a cur_len that ends exactly at a block's edge."""
    _blocks_merge_to_the_whole(7, t, cuts, cur_len, 8, 1)


def test_block_form_is_the_plain_decode_on_one_block():
    """One block holding the whole cache: o is ``decode_attention``'s output
    before its cast, lse the log of its softmax denominator; bf16 caches
    keep o in fp32."""
    from repro_torch.kernels.ref import decode_attention_ref
    q, k, v = _decode_case(3, 2, 20, 8, 2, 32)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        o, lse = decode_attention_ref(qd, kd, vd, 13, partial=True)
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        want = decode_attention_ref(qd, kd, vd, 13)
        np.testing.assert_allclose(o.to(dtype).float().numpy(), want.float().numpy(),
                                   rtol=1e-2 if dtype == torch.bfloat16 else 1e-6,
                                   atol=1e-2 if dtype == torch.bfloat16 else 1e-6)
    kf = k.repeat_interleave(4, dim=2)[:, :13]
    s = torch.einsum("bqhd,bthd->bht", q * (1.0 / np.sqrt(32)), kf)
    _, lse = decode_attention_ref(q, k, v, 13, partial=True)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-5, atol=1e-5)
