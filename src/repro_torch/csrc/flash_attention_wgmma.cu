// Prefill (causal or full) attention forward on Hopper's tensor cores
// (sm_90a, bf16 operands).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_fwd_kernel, launched by flash_attention_fwd), which the reference
// model computes with models/attention.py::blockwise_attention at the
// prefill call site. Same function: online softmax over kv tiles with fp32
// statistics and accumulators, masked scores set to -1e30 (not -inf) before
// the exponent, kv tiles above the causal diagonal skipped, output
// acc / max(l, 1e-30). q is (B, Sq, H, hd), k and v (B, Skv, K, hd), read
// through their strides with head_dim contiguous; q head h reads kv head
// h / (H/K) (jnp.repeat's mapping) without repeating kv. One deliberate
// numerical difference: the probabilities are rounded to bf16 before P.V,
// as in every tensor-core flash kernel (the TPU kernel keeps them in fp32).
// At S=1000, hd=128 that stays near 0.2 of the bf16 tolerance of
// tests/test_kernels.py (2e-2 abs + 2e-2 rel).
//
// What bounds it: operations. At the serve shape (B=8, S=1000, H=16, K=8,
// hd=128, causal) one call needs 4*B*H*hd*S(S+1)/2 = 32.8 GFLOP against
// 33 MB of q/k/v/o: 0.0332 ms at 989 TFLOP/s (bf16 tensor cores), while
// the bytes alone take 0.010 ms. The fp32 CUDA cores could not come near:
// their floor for the same work is 0.49 ms.
//
// What the design does about it:
//  * Both products run on wgmma (m64nNk16, bf16 in, fp32 accumulate). Each
//    block holds 128 q rows, 64 per consumer warpgroup. S = Q.K^T reads Q
//    (A) and the K tile (B) from shared memory, both K-major. O += P.V takes
//    P from registers: the fp32 accumulator fragment of S, converted
//    pairwise to bf16x2, is exactly the A-register fragment of the next
//    wgmma, so P never goes through shared memory. V is B, MN-major
//    (head_dim contiguous), read with the transpose bit.
//  * Shared memory holds bf16 only, in the swizzled layout the wgmma
//    descriptors name: 128-byte swizzle for hd 64, 128 and 256 (hd 128 and
//    256 are two and four 64-column atoms along head_dim), 64-byte for hd
//    32, 32-byte for hd 16.
//  * Copies are asynchronous and warp-specialized. One producer warp
//    issues TMA loads (cp.async.bulk.tensor, 4-d tensor maps over the
//    (B, S, heads, hd) strides, built on the host per call) into a ring of
//    three kv stages (two at hd 256), each with "full" mbarriers for K and
//    V and an "empty" one the consumers release; TMA writes the swizzled
//    layout itself and zero-fills the ragged edge. The two consumer
//    warpgroups never meet at a block barrier: each waits only for the
//    tiles it multiplies, so one warpgroup's softmax runs beside the
//    other's products. Every wait is bounded by a clock: a fault in the
//    protocol traps (a launch error) instead of hanging the card. The
//    tensor-map encoder is reached through cudaGetDriverEntryPoint, so the
//    library links only the CUDA runtime.
//  * Softmax overlaps the tensor cores twice. Inside a warpgroup, the
//    scores of tile j+1 and P_j . V_j are issued together and the softmax
//    of tile j+1 runs while P_j . V_j is still on the tensor cores (two
//    sets of P registers); the output is rescaled once it has landed.
//    Between the two warpgroups, a turn passed through mbarriers orders
//    their batches (FA3's ping-pong), so one warpgroup's softmax runs while
//    the tensor cores serve the other. The running max stays in raw score
//    units; log2(e) and the scale fold into one FFMA before each exponent,
//    a single ex2.approx.ftz.
//  * Causal work: tiles above the block's diagonal are never loaded, a
//    warpgroup skips tiles above its own rows, and only tiles that cross
//    the diagonal or the ragged end are masked. The q tiles are launched
//    longest first (reversed along the slowest grid axis), so the causal
//    tail does not end on a few SMs.
//  * head_dim 112 (zamba2-7b's) runs the hd-128 instantiation: the same
//    tiles in shared memory, the tensor maps built with head_dim 112 and
//    64-column boxes, so TMA zero-fills columns 112-127 of the second
//    swizzle atom. Q.K^T stops at column 112 (7 k-steps of 16), P.V's
//    columns 112-127 come out zero and are never stored. A third set of
//    tile constants would buy at most the 1/8 of P.V spent on those zeros.
//  * head_dim 80 (gpt2-2.7b's) runs the same hd-128 instantiation: the
//    tensor maps are built with head_dim 80, so the second 64-column box
//    reads 16 real columns and TMA zero-fills columns 80-127. Q.K^T stops
//    at column 80 (5 k-steps of 16: four in the first 128-byte swizzle
//    atom, one in the second); the 5 k-steps, the TMA extent and the 10
//    stored 8-column groups all come from HDV. P.V runs m64n128k16, so
//    3/8 of its work on these tiles is spent on zero columns (1/8 at hd
//    112), and the Q and K tiles in shared memory are 3/8 zeros: a native
//    80- or 96-wide tile with a narrower second swizzle atom is left for
//    the work that makes the kernel fast.
//  * head_dim 256 (gemma-2b's) has its own instantiation: four 64-column
//    swizzle atoms along head_dim, 64-row kv tiles, P.V on m64n256k16. Two
//    kv stages instead of three (Q 64 KB + 4 x 32 KB of K and V), and no
//    second set of P registers: the accumulator alone takes 128 of the 232
//    registers a consumer thread has, so the softmax of tile j+1 waits for
//    P_j . V_j (the overlap between the two warpgroups stays), FA3's design
//    at this head_dim.
//  * fp32 inputs keep the CUDA-core kernel in flash_attention.cu.

#include <atomic>

#include "wgmma.cuh"

namespace repro {
namespace {

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int NWG = 2;           // consumer warpgroups per block, 64 q rows each
constexpr int BQ = 64 * NWG;     // q rows per block
constexpr int NT = WG_THREADS * (NWG + 1);   // + the producer (one thread issues the copies)
// registers per thread after rebalancing: 128 * 40 + 256 * 232 <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is cached
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int BK = HD >= 128 ? 64 : 128;        // kv rows per tile
  static constexpr int W = HD < 64 ? HD : 64;            // elements per swizzled row
  static constexpr int SW = 2 * W;                       // its bytes: the swizzle width
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // descriptor code
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;           // one K or V tile
  // kv tiles in the ring: at hd 256, Q (64 KB) and three stages of K and V
  // (192 KB) would pass the 227 KB a block may have; two stages need 128 KB
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  // a second set of P registers beside the accumulator (the softmax of tile
  // j+1 under P_j . V_j): at hd 256 the accumulator alone is 128 registers
  static constexpr bool OVERLAP = HD <= 128;
  static constexpr int BARS = 3 + 3 * STAGES;  // q full, 2 turns; K, V full and empty per stage
  static constexpr size_t smem =
      Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS + 1024;   // + 1024 for alignment
};

// Online softmax of one 64 x BK score tile of a warpgroup, in place of the
// raw scores s: mask (only where `edge`), update the running max (m0, m1,
// in raw score units) and this thread's share of the running sums (l0, l1)
// of its rows row0 and row0 + 8, return their rescale factors (c0, c1), and
// leave P in bf16 in p, already in the A-fragment layout of m64nNk16:
// registers {0,1} row g cols 2t.., {2,3} row g+8, {4,5} row g cols 8+2t..,
// {6,7} row g+8 — the S accumulator's pairs in order. A row's scores live
// on the 4 lanes of one quad. p = exp2(s * scale_log2 - m * scale_log2),
// one FFMA and one exp2 per score.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], uint32_t (&p)[BK / 16][4],
                                               float& m0, float& m1, float& l0, float& l1,
                                               float& c0, float& c1, int kv0, int row0,
                                               int col, int Skv, bool causal, bool edge,
                                               float scale_log2) {
  if (edge) {
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + 8 * jj + col + (e & 1);
        const int qpos = row0 + 8 * (e >> 1);
        if (kpos >= Skv || (causal && kpos > qpos)) s[4 * jj + e] = kNegInf;
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int jj = 0; jj < BK / 8; ++jj) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  c0 = exp2_ftz((m0 - mn0) * scale_log2);
  c1 = exp2_ftz((m1 - mn1) * scale_log2);
  m0 = mn0;
  m1 = mn1;
  const float b0 = mn0 * scale_log2;
  const float b1 = mn1 * scale_log2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < BK / 8; ++jj) {
    const float p00 = exp2_ftz(fmaf(s[4 * jj], scale_log2, -b0));
    const float p01 = exp2_ftz(fmaf(s[4 * jj + 1], scale_log2, -b0));
    const float p10 = exp2_ftz(fmaf(s[4 * jj + 2], scale_log2, -b1));
    const float p11 = exp2_ftz(fmaf(s[4 * jj + 3], scale_log2, -b1));
    rs0 += p00 + p01;
    rs1 += p10 + p11;
    p[jj / 2][(jj % 2) * 2] = pack_bf16(p00, p01);
    p[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(p10, p11);
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
}

// HD: the tile instantiation; HDV: the tensors' head_dim (HD, or 80 or 112
// on the 128 tiles, whose columns from HDV on are zero in shared memory)
template <int HD, int HDV>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                   int H, int G, int Sq, int Skv, int causal, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  constexpr int ST = C::STAGES;
  constexpr int NA = HD / C::W;                // swizzle atoms along head_dim
  constexpr uint32_t SBO = 8 * C::SW;          // 8 rows of one swizzle atom

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;         // ST K tiles, then ST V tiles
  const uint32_t sV = sK + ST * C::KV_BYTES;
  const uint32_t q_full = sV + ST * C::KV_BYTES;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + ST + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + 2 * ST + st); };
  auto turn = [&](int w) { return q_full + 8 * (1 + 3 * ST + w); };

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest causal rows first
  const int n_tiles = ((causal ? min(Skv, q0 + BQ) : Skv) + BK - 1) / BK;
  // warp-uniform, so that ptxas sees the warpgroup's branches as such and
  // does not serialize the wgmma inside them
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 4 * NWG);           // one arrival per consumer warp
    }
    for (int w = 0; w < NWG; ++w) mbar_init(turn(w), 4);   // the other warpgroup's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {                             // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x != NWG * WG_THREADS) return;
    mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int a = 0; a < NA; ++a) tma_load(sQ + a * BQ * C::SW, &tq, q_full, a * C::W, h, q0, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % ST;
      if (t >= ST) mbar_wait(empty(st), (t / ST - 1) & 1);
      mbar_expect_tx(k_full(st), C::KV_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load(sK + st * C::KV_BYTES + a * BK * C::SW, &tk, k_full(st), a * C::W, kvh, t * BK, b);
      mbar_expect_tx(v_full(st), C::KV_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load(sV + st * C::KV_BYTES + a * BK * C::SW, &tv, v_full(st), a * C::W, kvh, t * BK, b);
    }
    return;
  }

  // consumer warpgroup wg: q rows q0w .. q0w + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int warp = (threadIdx.x % WG_THREADS) / 32;
  const int lane = threadIdx.x % 32;
  const int q0w = q0 + 64 * wg;
  const int row0 = q0w + 16 * warp + lane / 4;        // this thread's rows: row0, row0 + 8
  const int col = 2 * (lane % 4);                     // its columns in each 8: col, col + 1
  // tiles this warpgroup multiplies: its rows see no key past their own
  // diagonal, and rows past Sq are not computed
  const int wg_kv_end = q0w >= Sq ? 0 : causal ? min(Skv, q0w + 64) : Skv;
  const int wg_tiles = (wg_kv_end + BK - 1) / BK;

  // S = Q . K_t^T into s (64 x BK for this warpgroup), issued, not waited
  auto issue_scores = [&](float (&s)[BK / 2], int t) {
    const uint32_t sKt = sK + (t % ST) * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HDV / 16; ++kk) {      // the zero columns add nothing
      const uint32_t atom = (kk * 16) / C::W;
      const uint32_t in_row = ((kk * 16) % C::W) * 2;
      const uint64_t da = smem_desc(sQ + atom * BQ * C::SW + wg * 64 * C::SW + in_row,
                                    16, SBO, C::LAYOUT);
      const uint64_t db = smem_desc(sKt + atom * BK * C::SW + in_row, 16, SBO, C::LAYOUT);
      Wgmma<BK>::template ss<0, 0>(s, da, db, kk > 0);
    }
    wgmma_commit();
  };
  auto edge = [&](int t) {                 // the tile crosses the diagonal or the end
    return t * BK + BK > Skv || (causal && t * BK + BK - 1 > q0w);
  };
  auto release = [&](int t) {              // this warp is done with tile t's stage
    if (lane == 0) mbar_arrive(empty(t % ST));
  };
  // The two warpgroups take turns to issue their products (FA3's ping-pong):
  // while the tensor cores run one warpgroup's batch, the other runs its
  // softmax. A turn passes as soon as the batch is issued. Both warpgroups
  // take n_tiles + 1 turns, idle ones included, so the turns and the stage
  // releases keep one order and neither can wait for the other forever.
  auto take_turn = [&](int r) { mbar_wait(turn(wg), r & 1); };
  auto pass_turn = [&]() {
    if (lane == 0) mbar_arrive(turn(1 - wg));
  };
  if (wg == 1) pass_turn();                // warpgroup 0 goes first

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  auto rescale = [&](float c0, float c1) {   // rows row0 and row0 + 8 of the output
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      acc[4 * jj] *= c0;
      acc[4 * jj + 1] *= c0;
      acc[4 * jj + 2] *= c1;
      acc[4 * jj + 3] *= c1;
    }
  };
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows row0, row0 + 8 (raw scores)
  float l0 = 0.f, l1 = 0.f;           // this thread's share of their running sums
  float s[BK / 2];
  uint32_t pa[BK / 16][4];            // P of the tile whose P.V is next
  mbar_wait(q_full, 0);
  if (wg_tiles > 0) {
    float c0, c1;                     // acc is zero: nothing to rescale
    mbar_wait(k_full(0), 0);
    take_turn(0);
    wgmma_fence();
    issue_scores(s, 0);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax<BK>(s, pa, m0, m1, l0, l1, c0, c1, 0, row0, col, Skv, causal, edge(0),
                       scale_log2);
  } else {
    take_turn(0);
    pass_turn();
  }

  // tile j: P_j . V_j runs on the tensor cores while the softmax of tile
  // j+1, whose scores were issued just before it, runs on the CUDA cores.
  // On the warpgroup's last tile the scores are issued again from tile j's
  // own K (and dropped): a wgmma issued under a condition is serialized.
  // Tiles the block loads for the other warpgroup only are taken in turn
  // and released, so every stage's phases stay in step.
  for (int j = 0; j < n_tiles; ++j) {
    if (j < wg_tiles) {
      const bool next = j + 1 < wg_tiles;
      const int t1 = next ? j + 1 : j;
      if (next) mbar_wait(k_full(t1 % ST), (t1 / ST) & 1);
      mbar_wait(v_full(j % ST), (j / ST) & 1);
      take_turn(j + 1);
      fence_regs(acc);
      wgmma_fence();
      issue_scores(s, t1);
      const uint32_t sVj = sV + (j % ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<HD>::rs(acc, pa[kk], smem_desc(sVj + kk * 16 * C::SW, BK * C::SW, SBO, C::LAYOUT));
      wgmma_commit();
      pass_turn();
      float c0, c1;
      if constexpr (C::OVERLAP) {
        float mn0 = m0, mn1 = m1, ln0 = l0, ln1 = l1;
        uint32_t pn[BK / 16][4];
        wgmma_wait<1>();              // the scores of tile t1 (P_j . V_j may still run)
        fence_regs(s);
        online_softmax<BK>(s, pn, mn0, mn1, ln0, ln1, c0, c1, t1 * BK, row0, col, Skv, causal,
                           edge(t1), scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        release(j);
        if (next) {
          m0 = mn0;
          m1 = mn1;
          l0 = ln0;
          l1 = ln1;
          rescale(c0, c1);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
        }
      } else {                        // both products land, then P of tile t1 into pa
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(acc);
        release(j);
        if (next) {
          online_softmax<BK>(s, pa, m0, m1, l0, l1, c0, c1, t1 * BK, row0, col, Skv, causal,
                             edge(t1), scale_log2);
          rescale(c0, c1);
        }
      }
    } else {
      mbar_wait(k_full(j % ST), (j / ST) & 1);
      mbar_wait(v_full(j % ST), (j / ST) & 1);
      take_turn(j + 1);
      pass_turn();
      release(j);
    }
  }

  if (wg_tiles == 0) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // o is contiguous (B, Sq, H, HDV); columns from HDV on are not stored
  bf16* ob = o + ((long long)b * Sq * H + h) * HDV + col;
#pragma unroll
  for (int jj = 0; jj < HDV / 8; ++jj) {
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * H * HDV + 8 * jj) =
          pack_bf16(acc[4 * jj] * inv0, acc[4 * jj + 1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * H * HDV + 8 * jj) =
          pack_bf16(acc[4 * jj + 2] * inv1, acc[4 * jj + 3] * inv1);
  }
}

// A 4-d tensor map over a (B, S, heads, HDV) bf16 tensor with element
// strides st = (batch, position, head), in any order, 16-byte multiples;
// dims (HDV, heads, S, B), boxes of W head_dim columns by `rows` positions,
// swizzled as the wgmma descriptors of the HD tiles expect, zero past the
// ends (columns HDV..HD-1 too).
template <int HD, int HDV>
bool make_map(CUtensorMap* map, const void* base, int batch, int seq, int heads,
              const long long* st, int rows) {
  using C = Cfg<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {HDV, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::W, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(C::SW),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

template <int HD, int HDV = HD>
cudaError_t launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                               int B, int Sq, int Skv, int H, int K,
                               const long long* qs, const long long* ks,
                               const long long* vs, int causal, float scale,
                               cudaStream_t stream) {
  using C = Cfg<HD>;
  auto kernel = flash_wgmma_kernel<HD, HDV>;
  CUtensorMap tq, tk, tv;
  if (!make_map<HD, HDV>(&tq, q, B, Sq, H, qs, BQ)
      || !make_map<HD, HDV>(&tk, k, B, Skv, K, ks, C::BK)
      || !make_map<HD, HDV>(&tv, v, B, Skv, K, vs, C::BK))
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
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, NT, C::smem, stream>>>(tq, tk, tv, static_cast<bf16*>(o), H, H / K, Sq, Skv,
                                        causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// bf16 q (B, Sq, H, hd), k/v (B, Skv, K, hd). Strides are in elements, for
// the (batch, seq, head) axes; head_dim has stride 1 and every stride and
// pointer is 16-byte aligned (checked by the caller, as B*H < 2^31 and
// ceil(Sq/128) <= 65535). o is a contiguous (B, Sq, H, hd) buffer. Returns
// cudaGetLastError() after launch.
extern "C" int repro_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Skv, int H, int K, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)repro::launch_flash_wgmma<16>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 32: return (int)repro::launch_flash_wgmma<32>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 64: return (int)repro::launch_flash_wgmma<64>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 80: return (int)repro::launch_flash_wgmma<128, 80>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 112: return (int)repro::launch_flash_wgmma<128, 112>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 128: return (int)repro::launch_flash_wgmma<128>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 256: return (int)repro::launch_flash_wgmma<256>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
