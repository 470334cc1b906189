"""The algebra of the tensor-core SSD kernel (``csrc/ssd_wgmma.cu``), on the
CPU, against the reference: a numpy emulation of the kernel's walk over
64-row tiles with the running state carried from tile to tile, bf16
operands on every product, and the weighted operands (the decayed score
tile, w.x and the carried state) split into a bf16 high and low part. It is
held against the Pallas SSD in interpret mode (``repro.kernels.ops.ssd``)
and against ``ssd_chunked``: y at the bf16 tolerance of
tests/test_kernels.py (2e-2), the final state at 1e-3, the ragged last tile
and a carried-in state included. One bf16 pass on the weighted operands,
the rounding a tensor-core kernel would take by default, is shown to leave
the final state out of tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.models import mamba2 as tm

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
ROWS = 64            # the kernel's tile: rows of the sequence per step
LOG2E = np.float32(1.4426950408889634)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round to bf16 (nearest even, as the kernel's conversions) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _split(v: np.ndarray, hi_lo: bool):
    """The bf16 parts the kernel feeds the tensor cores for an fp32 operand:
    high and low (v - high, rounded again), or the high part alone."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if hi_lo else (hi,)


def _mm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A tensor-core product: bf16 operands, exact products, fp32 sum."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def ssd_tiles(x, dt, a, bm, cm, initial_state=None, hi_lo=True):
    """The kernel's algorithm in numpy. x (B, S, H, P), B and C (B, S, N)
    bf16-exact fp32; dt (B, S, H), a (H,) fp32. Returns (y (B, S, H, P)
    rounded to bf16, final state (B, H, N, P) fp32).

    Per (batch, head), tiles of 64 rows in order, rows past S read as zero:
    cs = cumsum(dt * a) within the tile; y = exp(cs_i) C.S + W.x with
    W_ij = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i; then
    S <- exp(cs_last) S + B^T (w x), w_j = dt_j exp(cs_last - cs_j)."""
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    tiles = -(-s // ROWS)
    pad = tiles * ROWS - s

    def padded(t):
        return np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
    x, dt, bm, cm = padded(x), padded(dt), padded(bm), padded(cm)
    y = np.zeros(x.shape, np.float32)
    final = np.zeros((bsz, h, n, p), np.float32)
    causal = np.tril(np.ones((ROWS, ROWS), bool))
    for b in range(bsz):
        for hh in range(h):
            state = (np.zeros((n, p), np.float32) if initial_state is None
                     else initial_state[b, hh].astype(np.float32))
            for t in range(tiles):
                rows = slice(t * ROWS, (t + 1) * ROWS)
                c_t, b_t, x_t = cm[b, rows], bm[b, rows], x[b, rows, hh]
                dt_t = dt[b, rows, hh]
                cs2 = np.cumsum((dt_t * a[hh]).astype(np.float32), dtype=np.float32) * LOG2E
                scores = _mm(c_t, b_t.T)                          # one bf16 pass
                acc = sum(_mm(c_t, part) for part in _split(state, hi_lo))
                acc *= np.exp2(cs2)[:, None]
                decay = np.exp2(np.where(causal, cs2[:, None] - cs2[None, :], 0.0))
                weights = np.where(causal, scores * decay * dt_t[None, :], 0.0)
                acc += sum(_mm(part, x_t) for part in _split(weights.astype(np.float32),
                                                             hi_lo))
                y[b, rows, hh] = acc
                w = dt_t * np.exp2(cs2[-1] - cs2)
                wx = (w[:, None] * x_t).astype(np.float32)
                state = np.exp2(cs2[-1]) * state + sum(_mm(b_t.T, part)
                                                       for part in _split(wx, hi_lo))
            final[b, hh] = state
    return _bf16(y[:, :s]), final


def _inputs(seed, b, s, h, p, n):
    """x, B, C bf16-exact; dt, a fp32: the distributions of
    tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    return (_bf16(rng.normal(size=(b, s, h, p))),
            rng.uniform(0.001, 0.1, size=(b, s, h)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32),
            _bf16(rng.normal(size=(b, s, n))), _bf16(rng.normal(size=(b, s, n))))


def _chunked(args, chunk, initial_state=None):
    """``ssd_chunked`` on bf16 tensors, as ``ops.ssd`` runs it on the CPU."""
    x, dt, a, bm, cm = args
    as_t = [torch.from_numpy(v) for v in args]
    for i in (0, 3, 4):
        as_t[i] = as_t[i].to(torch.bfloat16)
    init = None if initial_state is None else torch.from_numpy(initial_state)
    y, final = tm.ssd_chunked(*as_t, chunk=chunk, initial_state=init)
    return y.float().numpy(), final.numpy()


# (b, s, h, p, n, chunk): S ragged against the 64-row tile and the chunk
CASES = [(1, 300, 3, 64, 128, 256), (2, 200, 2, 32, 64, 64), (1, 77, 2, 16, 32, 16),
         (1, 129, 2, 128, 64, 256)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_tiled_split_matches_pallas_ssd(b, s, h, p, n, chunk):
    """The emulated kernel against the Pallas SSD kernel (interpreted) and
    its plain inter-chunk combine, bf16 inputs."""
    args = _inputs(20, b, s, h, p, n)
    y, final = ssd_tiles(*args)
    head_tile = 1 if h % 2 else 2
    jx, jdt, ja, jb, jc = (jnp.asarray(v, jnp.bfloat16 if i in (0, 3, 4) else jnp.float32)
                           for i, v in enumerate(args))
    yj, sj = j_ops.ssd(jx, jdt, ja, jb, jc, chunk=chunk, head_tile=head_tile)
    np.testing.assert_allclose(y, np.asarray(yj, np.float32), **BF16_TOL)
    np.testing.assert_allclose(final, np.asarray(sj, np.float32), **STATE_TOL)


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_tiled_split_matches_ssd_chunked(b, s, h, p, n, chunk, initial):
    """The emulated kernel against ``ssd_chunked`` (the port's plain version,
    what ``ops.ssd`` runs on the CPU), with and without a carried-in state."""
    args = _inputs(21, b, s, h, p, n)
    init = (np.random.default_rng(22).normal(size=(b, h, n, p)).astype(np.float32)
            if initial else None)
    y, final = ssd_tiles(*args, initial_state=init)
    y_ref, final_ref = _chunked(args, chunk, init)
    np.testing.assert_allclose(y, y_ref, **BF16_TOL)
    np.testing.assert_allclose(final, final_ref, **STATE_TOL)


def test_one_bf16_pass_leaves_the_state_out_of_tolerance():
    """Why the kernel splits the weighted operands: with one bf16 pass on
    them the final state misses 1e-3 at S=1000 (the serve length); with the
    split it lies far inside."""
    args = _inputs(23, 1, 1000, 2, 64, 128)
    _, final_ref = _chunked(args, 256)
    scale = 1e-3 + 1e-3 * np.abs(final_ref)
    ratios = {hi_lo: np.max(np.abs(ssd_tiles(*args, hi_lo=hi_lo)[1] - final_ref) / scale)
              for hi_lo in (True, False)}
    assert ratios[True] < 0.1, ratios
    assert ratios[False] > 1.0, ratios


def test_wgmma_route_refuses_cpu_tensors():
    """bf16 goes to the tensor-core route, which launches its kernel or
    raises: CPU tensors are refused and counted nowhere (``ops.ssd`` gives
    them to the plain version)."""
    from repro_torch.kernels import ssd as tssd
    args = [torch.from_numpy(v) for v in _inputs(24, 1, 16, 2, 16, 16)]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    launches, routes = tssd.ssd.launches, dict(tssd.ssd.routes)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd(*args, chunk=8)
    assert tssd.ssd.launches == launches and tssd.ssd.routes == routes
