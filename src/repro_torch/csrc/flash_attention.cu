// Prefill (causal or full) attention forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_fwd_kernel, launched by flash_attention_fwd) for fp32 inputs; bf16
// inputs go to the tensor-core kernel in flash_attention_wgmma.cu. Same
// math: online softmax over kv tiles with fp32 accumulators, masked scores
// set to -1e30 (not -inf), kv tiles above the causal diagonal skipped,
// output acc / max(l, 1e-30).
//
// Why fp32 stays on the CUDA cores: the tensor cores take fp32 operands
// only as TF32, which keeps about three decimal digits; the fp32 slice
// checks hold the card against the CPU at 2e-4, which TF32 could not meet.
//
// What bounds it: operations. At the serve shapes (B=8, S=1000, H=16, K=8,
// hd=128) one layer needs 4*B*H*hd*S(S+1)/2 = 32.8 GFLOP; on the fp32 CUDA
// cores (67 TFLOP/s) that is a 0.49 ms floor.
//
// What this design does about it: it keeps every intermediate out of device
// memory (one 64-row q tile, the current 64-row k/v tiles and the 64x64
// probability tile live in shared memory, the scores and the output
// accumulators in registers), reads q/k/v once per tile through their
// strides in the (B, S, H, hd) layout, with no transpose copy and no
// repeated kv heads (q head h reads kv head h / (H/K), jnp.repeat's
// mapping), and masks the ragged edge so any length works. The products
// are register-tiled (4x8 scores and 4x(hd/8) outputs per thread, 16-byte
// shared-memory loads). head_dim 112 runs the hd-128 layout with the loads
// of columns 112-127 predicated off (zero in shared memory), the scores'
// sum stopped at column 112 and those columns of the output not stored;
// head_dim 80 (gpt2-2.7b's) the same way, with columns 80-127 off.
// head_dim 256 keeps the same tiles: 128 output accumulators a thread, and
// 211 KB of shared memory (q, k, v and P tiles), one block an SM.

#include <atomic>

#include "common.cuh"

namespace repro {
namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int NT = 128;         // threads: 16 row groups (ty) x 8 lanes (tx)
constexpr int kMaxDevices = 64; // devices whose shared-memory opt-in is cached

template <int HD>
struct FlashSmem {
  static constexpr int QS = HD + 4;   // row strides in floats (bank spread,
  static constexpr int KS = HD + 4;   // 16-byte aligned rows)
  static constexpr int VS = HD;
  static constexpr int PS = BK + 4;
  static constexpr int floats = BQ * QS + BK * KS + BK * VS + BQ * PS;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// Copy `nrows` rows of HD elements (row i at base + i*row_stride, HDV of
// them in memory) into shared memory times `mul`; rows >= `valid` and
// columns >= HDV are zero.
template <int HD, int HDV>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const float* base, long long row_stride,
                                          int nrows, int valid, float mul) {
  constexpr int N = Vec16<float>::N;
  constexpr int CHUNKS = HD / N;
  for (int idx = threadIdx.x; idx < nrows * CHUNKS; idx += NT) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * N;
    float buf[N];
    if (r < valid && c < HDV) {
      Vec16<float>::load(base + r * row_stride + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) buf[e] = 0.f;
    }
    float* out = dst + r * dst_stride + c;
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = buf[e] * mul;
  }
}

// HD: the layout instantiation; HDV: the tensors' head_dim (HD, or 80 or
// 112 in the 128 layout)
template <int HD, int HDV>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int H, int G, int Sq, int Skv,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 int causal, float scale) {
  using S = FlashSmem<HD>;
  constexpr int VEC = HD >= 32 ? 4 : 2;      // output columns per vector
  constexpr int NJ = HD / (8 * VEC);         // vectors per thread per row
  constexpr int NC = HD / 8;                 // output columns per thread

  extern __shared__ float4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BQ * S::QS;
  float* sV = sK + BK * S::KS;
  float* sP = sV + BK * S::VS;

  const int tid = threadIdx.x;
  const int ty = tid / 8;                    // rows 4*ty .. 4*ty+3
  const int tx = tid % 8;                    // score cols tx + 8*j
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / G;

  const float* qb = q + b * q_sb + (long long)q0 * q_ss + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  load_tile<HD, HDV>(sQ, S::QS, qb, q_ss, BQ, min(BQ, Sq - q0), scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BK;
    __syncthreads();                         // previous tile fully consumed
    load_tile<HD, HDV>(sK, S::KS, kb + (long long)kv0 * k_ss, k_ss, BK,
                       min(BK, Skv - kv0), 1.f);
    load_tile<HD, HDV>(sV, S::VS, vb + (long long)kv0 * v_ss, v_ss, BK,
                       min(BK, Skv - kv0), 1.f);
    __syncthreads();

    // scores: s[i][j] = q[4ty+i] . k[tx+8j]
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDV; d += 4) {          // the zero columns add nothing
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * S::QS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + (tx + 8 * j) * S::KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // mask, online softmax; a row's 64 scores live on the 8 lanes of one ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = kv0 + tx + 8 * j;
        const bool ok = kpos < Skv && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(4 * ty + i) * S::PS + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();   // rows 4ty.. of sP are read only by the same warp

    // acc[i][cols] += p[4ty+i][:] @ v[:, cols]; cols = VEC*tx + 8*VEC*jj + e
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * S::PS + kk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* vrow = sV + (kk + r) * S::VS;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          float vv[VEC];
          if constexpr (VEC == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(vrow + VEC * tx + 8 * VEC * jj);
            vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
          } else {
            const float2 t2 = *reinterpret_cast<const float2*>(vrow + VEC * tx + 8 * VEC * jj);
            vv[0] = t2.x; vv[1] = t2.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = r == 0 ? pv[i].x : r == 1 ? pv[i].y : r == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][jj * VEC + e] = fmaf(p, vv[e], acc[i][jj * VEC + e]);
          }
        }
      }
    }
  }

  // o is contiguous (B, Sq, H, HDV); columns from HDV on are not stored
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * Sq + qpos) * H + h) * HDV;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (VEC * tx + 8 * VEC * jj >= HDV) continue;   // HDV is a multiple of VEC
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[VEC * tx + 8 * VEC * jj + e] = acc[i][jj * VEC + e] * inv;
    }
  }
}

template <int HD, int HDV = HD>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Skv, int H, int K,
                         const long long* qs, const long long* ks,
                         const long long* vs, int causal, float scale,
                         cudaStream_t stream) {
  using S = FlashSmem<HD>;
  auto kernel = flash_fwd_kernel<HD, HDV>;
  // above 48 KB of shared memory only after opting in, once per device
  // and instantiation rather than on every launch
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::bytes);
    if (err != cudaSuccess) return err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, S::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, H / K, Sq, Skv,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// fp32 q (B, Sq, H, hd), k/v (B, Skv, K, hd). Strides are in elements, for
// the (batch, seq, head) axes; the head_dim axis must have stride 1. o is a
// contiguous (B, Sq, H, hd) buffer. Returns cudaGetLastError() after launch.
extern "C" int repro_flash_attention_fp32(
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
    case 16: return (int)repro::launch_flash<16>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 32: return (int)repro::launch_flash<32>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 64: return (int)repro::launch_flash<64>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 80: return (int)repro::launch_flash<128, 80>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 112: return (int)repro::launch_flash<128, 112>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 128: return (int)repro::launch_flash<128>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    case 256: return (int)repro::launch_flash<256>(q, k, v, o, B, Sq, Skv, H, K, qs, ks, vs, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
