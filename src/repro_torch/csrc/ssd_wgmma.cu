// Mamba2 SSD, the whole of it, on Hopper's tensor cores (sm_90a, bf16 x, B
// and C; dt, a and the state in fp32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py
// (_ssd_chunk_kernel, launched by ssd_intra_chunk) together with the plain
// inter-chunk combine around it in the reference's ssd() (the scan over
// chunk states and y_inter = C . S_prev exp(cs)). Same function as
// models/mamba2.py::ssd_chunked: for each batch row and head h, with
// cs_i = sum_{k<=i} dt_k a_h,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j + exp(cs_i) C_i . S0
//   S_end = exp(cs_last) S0 + sum_j dt_j exp(cs_last - cs_j) B_j (x) x_j
// y leaves the kernel once, in bf16: the fp32 sum of both terms rounded once,
// as the reference casts. The final state is fp32, S0 the optional
// initial state (else zero).
//
// What bounds it: bytes. At the serve shape (B=8, S=1000, H=80, P=64,
// N=128, bf16) it must read x (81.9 MB), dt (2.6 MB), B and C (4.1 MB) and
// write y (81.9 MB) and the final state (21.0 MB): 191.5 MB, 0.0572 ms at
// 3.35 TB/s. The work, counted as the reference's chunks of 256 define it,
// is about 31.5 GFLOP (0.032 ms at 989 TFLOP/s).
//
// Precision: the decayed weights are unnormalised (|C.B| ~ 11, |y| up to
// 18), so a weighted operand rounded once to bf16 leaves the state and y
// outside the reference's tolerances (1e-3 and 2e-2): a numpy emulation of
// this kernel (tests/test_torch_ssd_split.py) puts one bf16 pass at 1.84x
// the state tolerance and 1.12x y's, at S=1000. So every weighted operand
// goes to the tensor cores as a bf16 high part and a bf16 low part (v - hi,
// rounded again), two wgmmas into one fp32 accumulator: about 16 bits of
// mantissa, 0.003x and 0.25x of the tolerances in that emulation. This
// holds for the decayed score tile, for w.x of the state update and for the
// carried state of the inter-chunk term. The scores C.B^T take one pass:
// C and B are bf16 already and the sum is fp32.
//
// What the design does:
//  * The walk over the sequence is a loop inside the block, in place of the
//    TPU's sequential chunk axis: one block per (batch row, pair of heads),
//    one warpgroup per head, and the running state, kept transposed as
//    S^T (P x N, fp32), never leaves the warpgroup's accumulator registers.
//    The loop takes 64 rows per step, whatever the caller's chunk: the SSD
//    is the same function for any chunk length (the chunk sets only the
//    reference's rounding), and 64 rows are one wgmma row tile, so the
//    causal score tile of a step is a single 64 x 64 square.
//  * Per step and head: cs by a warp scan of dt * a (da rounded first, as
//    the reference); y = C . (S_hi + S_lo) issued; while it runs, w.x is
//    split into bf16 parts in shared memory and W = scores exp(cs_i - cs_j)
//    dt_j (masked before the exponent) into high and low A fragments in
//    registers (flash's P-in-registers mapping, twice); then y is scaled by
//    exp(cs_i), y += W_hi . x + W_lo . x, S^T <- exp(cs_last) S^T +
//    (wx_hi + wx_lo)^T . B (A = w.x and B = the B tile, both MN-major, one
//    m64nN_pad instruction per 16 rows), and the next step's scores C . B^T
//    are issued with them, so a step waits for the tensor cores twice. y
//    goes out once in bf16: swizzled into the head's x tile of the stage,
//    then one TMA store; S's bf16 parts go to shared memory for the next
//    step's inter term.
//  * Thread 0 keeps the next step's C, B and both heads' x tiles in flight by
//    TMA (two stages, mbarriers, 128/64/32-byte swizzle as the descriptors
//    name), so a warpgroup runs at most one step ahead of the other. There
//    is no producer warp: a block of 288 or 384 threads is compiled for 168
//    registers a thread and the state spills; 256 threads get 255. TMA
//    zero-fills rows past S and state columns past N (N is padded to 64 or
//    128); dt is read as zero there, so such rows add nothing to y or S. A
//    missing second head (H odd) computes on a real head's data and stores
//    nothing.
//  * The two heads of a block share the C and B tiles; each warpgroup
//    computes its own score tile (2.1 of about 7.3 MFLOP a step at N=128,
//    P=64). Every wait is bounded by a clock and traps.
//  * Shapes: P in {16, 32, 64, 128}, N a multiple of 8 up to 128 (up to 64
//    at P=128): the state, N padded to 64-column tiles, must fit the
//    registers (N_pad x P <= 8192 fp32 per warpgroup). fp32 inputs keep the
//    CUDA-core kernel in ssd.cu.

#include <atomic>

#include "wgmma.cuh"

namespace repro {
namespace {

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int NWG = 2;           // consumer warpgroups per block, one head each
// No producer warp: one consumer thread issues the copies, so that ptxas
// may give every thread up to 255 registers (a block of 288 or 384 threads
// is compiled for 168, and the state spills)
constexpr int NT = WG_THREADS * NWG;
constexpr int ROWS = 64;         // sequence rows per step
constexpr int STAGES = 2;        // steps of C, B and x in the ring
constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is cached
constexpr float kLog2e = 1.4426950408889634f;

template <int P, int MT>
struct SsdCfg {
  static constexpr int NP = 64 * MT;                 // state rows, N padded
  static constexpr int W = P < 64 ? P : 64;          // P columns per swizzled row
  static constexpr int SW = 2 * W;                   // its bytes: the swizzle width
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // descriptor code
  static constexpr int BC_BYTES = ROWS * NP * 2;     // a C or B tile: MT atoms of 64 columns
  static constexpr int X_BYTES = ROWS * P * 2;       // one head's x tile (also w.x)
  static constexpr int STAGE_BYTES = 2 * BC_BYTES + NWG * X_BYTES;
  static constexpr int MP = P < 64 ? 1 : P / 64;     // 64-row tiles of the state along P
  static constexpr int S_BYTES = NP * P * 2;         // one bf16 part of the state
  static constexpr int WX_BYTES = ROWS * 64 * MP * 2;  // one part of w.x, P padded to 64
  static constexpr int WG_BYTES = 2 * S_BYTES + 2 * WX_BYTES;  // S and w.x, high and low
  static constexpr size_t smem =
      STAGES * STAGE_BYTES + NWG * WG_BYTES + 8 * 2 * STAGES + 1024;  // + 1024 for alignment
};

// Byte offset of element (row, col) in a buffer of 2-byte elements stored
// as atoms of W columns (SW bytes a row) by `rows` rows, swizzled as TMA and
// wgmma do (Swizzle<log2(SW/16), 4, 3>); the buffer is 1024-byte aligned.
template <int SW>
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  constexpr int W = SW / 2;
  const uint32_t off = (col / W) * rows * SW + row * SW + (col % W) * 2;
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// bf16 high and low parts of two fp32 values, each pair packed (first value
// in the low half): hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG_THREADS) : "memory");
}

template <int P, int MT>
__global__ void __launch_bounds__(NT, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const float* __restrict__ init, float* __restrict__ final_state, int S, int H,
                 int N) {
  using C = SsdCfg<P, MT>;
  constexpr int NP = C::NP;
  constexpr int SW = C::SW;
  constexpr int NA = P / C::W;                 // swizzle atoms along P
  constexpr int ND = P / 2;                    // accumulator registers of a 64 x P tile
  constexpr int MP = C::MP;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  auto stage = [&](int st) { return base + st * C::STAGE_BYTES; };
  const uint32_t wg_base = base + STAGES * C::STAGE_BYTES;
  const uint32_t bars = wg_base + NWG * C::WG_BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  const int groups = (H + NWG - 1) / NWG;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * NWG;
  const int steps = (S + ROWS - 1) / ROWS;
  // warp-uniform, so that ptxas sees the warpgroup's branches as such and
  // does not serialize the wgmma inside them
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NWG);               // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // C, B and both heads' x of step t into its stage, by thread 0
  const CUtensorMap* const map_x = &tx;
  const CUtensorMap* const map_b = &tb;
  const CUtensorMap* const map_c = &tc;
  const CUtensorMap* const map_y = &ty;
  auto issue = [&](int t) {
    const int st = t % STAGES;
    mbar_expect_tx(full(st), C::STAGE_BYTES);
    const uint32_t s0 = stage(st);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      tma_load(s0 + m * ROWS * 128, map_c, full(st), 64 * m, t * ROWS, b);
      tma_load(s0 + C::BC_BYTES + m * ROWS * 128, map_b, full(st), 64 * m, t * ROWS, b);
    }
#pragma unroll
    for (int g = 0; g < NWG; ++g) {
      const int hg = min(h0 + g, H - 1);       // a missing head reads a real one, unused
#pragma unroll
      for (int at = 0; at < NA; ++at)
        tma_load(s0 + 2 * C::BC_BYTES + g * C::X_BYTES + at * ROWS * SW, map_x, full(st),
                 at * C::W, hg, t * ROWS, b);
    }
  };
  if (threadIdx.x == 0) issue(0);

  // warpgroup wg: head h
  const int h = h0 + wg;
  const bool live = h < H;                     // uniform in the warpgroup
  const int hc = live ? h : H - 1;
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                      // accumulator rows g and g + 8 of the warp's 16
  const int col = 2 * (lane % 4);              // its columns in each 8: col, col + 1
  const float ah = a[hc];
  const uint32_t sS = wg_base + wg * C::WG_BYTES;          // S high part, then low
  const uint32_t sWX = sS + 2 * C::S_BYTES;                // w.x high part, then low
  uint8_t* const pS = base_ptr + (sS - base);
  uint8_t* const pWX = base_ptr + (sWX - base);

  // the state, transposed: S^T (P x N) in 64-row tiles along P, rows
  // p = 64 mp + 16 warp + g (+ 8), columns n = 8 jj + col (+ 1)
  float state[MP][NP / 2];
#pragma unroll
  for (int mp = 0; mp < MP; ++mp)
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 64 * mp + 16 * warp + g + 8 * (e >> 1);
        const int n = 8 * jj + col + (e & 1);
        state[mp][4 * jj + e] =
            init != nullptr && n < N && pp < P
                ? init[(((long long)b * H + hc) * N + n) * P + pp] : 0.f;
      }

  // bf16 parts of the state into shared memory, as the B operand (K = n,
  // N = p, K-major: rows p of 128-byte swizzled atoms of 64 n) of the
  // inter-chunk product
  auto store_state_parts = [&]() {
#pragma unroll
    for (int mp = 0; mp < MP; ++mp)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int pp = 64 * mp + 16 * warp + g + 8 * hf;
        if (pp >= P) continue;
#pragma unroll
        for (int jj = 0; jj < NP / 8; ++jj) {
          uint32_t hi, lo;
          split2(state[mp][4 * jj + 2 * hf], state[mp][4 * jj + 2 * hf + 1], hi, lo);
          const uint32_t off = swz<128>(pp, 8 * jj + col, P);
          *reinterpret_cast<uint32_t*>(pS + off) = hi;
          *reinterpret_cast<uint32_t*>(pS + C::S_BYTES + off) = lo;
        }
      }
    fence_proxy_async();
  };
  store_state_parts();
  wg_sync(wg);

  // dt of rows 2 lane and 2 lane + 1 of step t (every warp holds the step)
  auto load_dt = [&](int t, float& d0, float& d1) {
    const int row = t * ROWS + 2 * lane;
    const float* p = dt + ((long long)b * S + row) * H + hc;
    d0 = row < S ? p[0] : 0.f;
    d1 = row + 1 < S ? p[H] : 0.f;
  };
  float d0, d1;
  load_dt(0, d0, d1);

  // scores = C . B^T (64 x 64) of the step in stage st, issued, not waited
  float s[32];
  auto issue_scores = [&](int st) {
    const uint32_t sC = stage(st);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t k_off = (kk / 4) * ROWS * 128 + (kk % 4) * 32;
      Wgmma<64>::template ss<0, 0>(s, smem_desc(sC + k_off, 16, 1024, 1),
                                   smem_desc(sC + C::BC_BYTES + k_off, 16, 1024, 1), kk > 0);
    }
  };
  mbar_wait(full(0), 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  for (int t = 0; t < steps; ++t) {
    const int st = t % STAGES;
    // step t + 1 into the stage that both warpgroups released after step
    // t - 1: a warpgroup runs at most one step ahead of the other
    if (threadIdx.x == 0 && t + 1 < steps) {
      if (t >= 1) mbar_wait(empty((t + 1) % STAGES), ((t - 1) / STAGES) & 1);
      issue(t + 1);
    }
    float n0 = 0.f, n1 = 0.f;
    if (t + 1 < steps) load_dt(t + 1, n0, n1);    // ahead of its use

    // cs (times log2 e) of rows 2 lane, 2 lane + 1: a scan over the warp
    const float da0 = __fmul_rn(d0, ah);
    const float da1 = __fmul_rn(d1, ah);
    float incl = da0 + da1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float cs0 = (excl + da0) * kLog2e;
    const float cs1 = (excl + da0 + da1) * kLog2e;
    const float last = __shfl_sync(0xffffffffu, cs1, 31);
    const float w0 = d0 * exp2_ftz(last - cs0);     // state weights of the lane's rows
    const float w1 = d1 * exp2_ftz(last - cs1);

    const uint32_t sC = stage(st);
    const uint32_t sB = sC + C::BC_BYTES;
    const uint32_t sX = sB + C::BC_BYTES + wg * C::X_BYTES;
    uint8_t* const pX = base_ptr + (sX - base);
    mbar_wait(full(st), (t / STAGES) & 1);

    // acc = C . (S_hi + S_lo) (64 x P); this step's scores are in s, issued
    // with the previous step's products
    float acc[ND];
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        const uint32_t k_off = (kk / 4) * ROWS * 128 + (kk % 4) * 32;
        Wgmma<P>::template ss<0, 0>(
            acc, smem_desc(sC + k_off, 16, 1024, 1),
            smem_desc(sS + part * C::S_BYTES + (kk / 4) * P * 128 + (kk % 4) * 32, 16, 1024, 1),
            part > 0 || kk > 0);
      }
    wgmma_commit();

    // meanwhile: w.x in bf16 parts, 16 bytes (8 columns of one row) at a
    // time, into 128-byte swizzled atoms of 64 columns (the A operand of the
    // state update, MN-major); columns past P are never read into S
#pragma unroll
    for (int k = 0; k < P / 16; ++k) {
      const int c = tid + WG_THREADS * k;
      const int r = c / (P / 8);
      const int pc = (c % (P / 8)) * 8;
      const uint32_t off = swz<SW>(r, pc, ROWS);
      const uint32_t woff = swz<128>(r, pc, ROWS);
      const float wa = __shfl_sync(0xffffffffu, w0, r / 2);
      const float wb = __shfl_sync(0xffffffffu, w1, r / 2);
      const float w = (r & 1) ? wb : wa;
      float v[8];
      Vec16<bf16>::widen(*reinterpret_cast<const uint4*>(pX + off), v);
      uint4 hi, lo;
      uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) split2(w * v[2 * e], w * v[2 * e + 1], hp[e], lp[e]);
      *reinterpret_cast<uint4*>(pWX + woff) = hi;
      *reinterpret_cast<uint4*>(pWX + C::WX_BYTES + woff) = lo;
    }
    fence_proxy_async();

    // cs of this thread's rows i0 = 16 warp + g and i0 + 8
    const int i0 = 16 * warp + g;
    float ci[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int src = (i0 + 8 * hf) / 2;
      const float c0 = __shfl_sync(0xffffffffu, cs0, src);
      const float c1 = __shfl_sync(0xffffffffu, cs1, src);
      ci[hf] = (g & 1) ? c1 : c0;
    }
    // W = scores exp(cs_i - cs_j) dt_j (j <= i) as high and low A fragments,
    // while the inter term runs
    uint32_t wh[4][4], wl[4][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int src = 4 * jj + lane % 4;         // holds columns 8 jj + col, + 1
      const float cj0 = __shfl_sync(0xffffffffu, cs0, src);
      const float cj1 = __shfl_sync(0xffffffffu, cs1, src);
      const float dj0 = __shfl_sync(0xffffffffu, d0, src);
      const float dj1 = __shfl_sync(0xffffffffu, d1, src);
      const int j = 8 * jj + col;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1);
        const int jc = j + (e & 1);
        const float arg = ci[e >> 1] - ((e & 1) ? cj1 : cj0);
        const float dtj = (e & 1) ? dj1 : dj0;
        v[e] = jc <= i ? s[4 * jj + e] * exp2_ftz(arg) * dtj : 0.f;   // masked before use
      }
      split2(v[0], v[1], wh[jj / 2][(jj % 2) * 2], wl[jj / 2][(jj % 2) * 2]);
      split2(v[2], v[3], wh[jj / 2][(jj % 2) * 2 + 1], wl[jj / 2][(jj % 2) * 2 + 1]);
    }
    const float decay = exp2_ftz(last);
#pragma unroll
    for (int mp = 0; mp < MP; ++mp)
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) state[mp][i] *= decay;
    // y rows of the inter term scaled by exp(cs_i)
    wgmma_wait<0>();
    fence_regs(acc);
    const float r0 = exp2_ftz(ci[0]);
    const float r1 = exp2_ftz(ci[1]);
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj) {
      acc[4 * jj] *= r0;
      acc[4 * jj + 1] *= r0;
      acc[4 * jj + 2] *= r1;
      acc[4 * jj + 3] *= r1;
    }
    wg_sync(wg);                                  // every thread's w.x parts are written

    // y += W_hi . x + W_lo . x;  S^T += (wx_hi + wx_lo)^T . B
#pragma unroll
    for (int mp = 0; mp < MP; ++mp) fence_regs(state[mp]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = smem_desc(sX + kk * 16 * SW, ROWS * SW, 8 * SW, C::LAYOUT);
      Wgmma<P>::rs(acc, wh[kk], dx);
      Wgmma<P>::rs(acc, wl[kk], dx);
    }
#pragma unroll
    for (int mp = 0; mp < MP; ++mp)
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<NP>::template ss<1, 1>(
              state[mp],
              smem_desc(sWX + part * C::WX_BYTES + mp * ROWS * 128 + kk * 16 * 128, ROWS * 128,
                        1024, 1),
              smem_desc(sB + kk * 16 * 128, ROWS * 128, 1024, 1), 1);
    // and the next step's scores (on the last step this step's again, unused:
    // ptxas serializes a wgmma under a branch)
    const int next = t + 1 < steps ? t + 1 : t;
    mbar_wait(full(next % STAGES), (next / STAGES) & 1);
    issue_scores(next % STAGES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(s);
#pragma unroll
    for (int mp = 0; mp < MP; ++mp) fence_regs(state[mp]);
    // y in bf16 into this head's x tile (read by now), for one TMA store
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int jj = 0; jj < P / 8; ++jj)
        *reinterpret_cast<uint32_t*>(pX + swz<SW>(i0 + 8 * hf, 8 * jj + col, ROWS)) =
            pack_bf16(acc[4 * jj + 2 * hf], acc[4 * jj + 2 * hf + 1]);
    fence_proxy_async();
    if (t + 1 < steps) store_state_parts();
    wg_sync(wg);                                  // y and S parts written; w.x no longer read
    if (tid == 0) {
      if (live) {                                 // rows past S are dropped by the map
#pragma unroll
        for (int at = 0; at < NA; ++at)
          tma_store(map_y, sX + at * ROWS * SW, at * C::W, h, t * ROWS, b);
        bulk_commit();
        bulk_wait<0, true>();                     // y has left the stage
      }
      mbar_arrive(empty(st));                     // the warpgroup is done with the stage
    }
    d0 = n0;
    d1 = n1;
  }

  if (tid == 0) bulk_wait<0, false>();            // y written
  // final_state is contiguous (B, H, N, P), fp32
  if (!live) return;
#pragma unroll
  for (int mp = 0; mp < MP; ++mp)
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 64 * mp + 16 * warp + g + 8 * (e >> 1);
        const int n = 8 * jj + col + (e & 1);
        if (n < N && pp < P)
          final_state[(((long long)b * H + h) * N + n) * P + pp] = state[mp][4 * jj + e];
      }
}

// A bf16 tensor map over `rank` dims (innermost first) with byte strides
// of the outer dims, boxes `box`, swizzled for rows of `row_bytes`, zero
// past the ends.
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box, int row_bytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(row_bytes),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

template <int P, int MT>
cudaError_t launch_ssd_wgmma(const void* x, const float* dt, const float* a, const void* bm,
                             const void* cm, const float* init, void* y, float* final_state,
                             int B, int S, int H, int N, cudaStream_t stream) {
  using C = SsdCfg<P, MT>;
  auto kernel = ssd_wgmma_kernel<P, MT>;
  CUtensorMap tx, tb, tc, ty;
  const cuuint64_t x_dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2,
                                   (cuuint64_t)S * H * P * 2};
  const cuuint32_t x_box[4] = {(cuuint32_t)C::W, 1, ROWS, 1};
  const cuuint64_t bc_dims[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t bc_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)S * N * 2};
  const cuuint32_t bc_box[3] = {64, ROWS, 1};
  if (!make_map(&tx, x, 4, x_dims, x_strides, x_box, C::SW)
      || !make_map(&ty, y, 4, x_dims, x_strides, x_box, C::SW)
      || !make_map(&tb, bm, 3, bc_dims, bc_strides, bc_box, 128)
      || !make_map(&tc, cm, 3, bc_dims, bc_strides, bc_box, 128))
    return cudaErrorInvalidValue;
  // above 48 KB of shared memory only after opting in, once per device
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::smem);
    if (err != cudaSuccess) return err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const int groups = (H + NWG - 1) / NWG;
  kernel<<<B * groups, NT, C::smem, stream>>>(tx, tb, tc, ty, dt, a, init, final_state, S, H, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// bf16 x (B, S, H, P), B and C (B, S, N); fp32 dt (B, S, H), a (H,) and
// init (B, H, N, P) or null for a zero initial state; all contiguous and
// 16-byte aligned. Outputs: y (B, S, H, P) bf16, final_state (B, H, N, P)
// fp32. P in {16, 32, 64, 128}; N % 8 == 0 and N <= 128 (N <= 64 at
// P = 128); B * ceil(H / 2) < 2^31 (checked by the caller). Returns
// cudaGetLastError() after the launch.
extern "C" int repro_ssd_wgmma(const void* x, const void* dt, const void* a, const void* bm,
                               const void* cm, const void* init, void* y, void* final_state,
                               int B, int S, int H, int P, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* in = static_cast<const float*>(init);
  float* fs = static_cast<float*>(final_state);
  if (N % 8 != 0 || N < 8 || N > 128 || S < 1 || H < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const bool one = N <= 64;                    // one 64-row tile of state rows
  switch (P) {
    case 16: return one ? (int)repro::launch_ssd_wgmma<16, 1>(x, dtf, af, bm, cm, in, y, fs, B, S, H, N, st)
                        : (int)repro::launch_ssd_wgmma<16, 2>(x, dtf, af, bm, cm, in, y, fs, B, S, H, N, st);
    case 32: return one ? (int)repro::launch_ssd_wgmma<32, 1>(x, dtf, af, bm, cm, in, y, fs, B, S, H, N, st)
                        : (int)repro::launch_ssd_wgmma<32, 2>(x, dtf, af, bm, cm, in, y, fs, B, S, H, N, st);
    case 64: return one ? (int)repro::launch_ssd_wgmma<64, 1>(x, dtf, af, bm, cm, in, y, fs, B, S, H, N, st)
                        : (int)repro::launch_ssd_wgmma<64, 2>(x, dtf, af, bm, cm, in, y, fs, B, S, H, N, st);
    case 128: return one ? (int)repro::launch_ssd_wgmma<128, 1>(x, dtf, af, bm, cm, in, y, fs, B, S, H, N, st)
                         : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}
