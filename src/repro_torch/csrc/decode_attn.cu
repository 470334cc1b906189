// GQA decode attention (one query token against the KV cache) for Hopper
// (sm_90a), split over the cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn.py
// (_decode_kernel, launched by decode_attention), which the reference model
// computes with models/attention.py::decode_attention in
// self_attention_decode. Same math as the TPU kernel: positions >= cur_len
// are never read, an online softmax per (kv head, group member) in fp32
// throughout, output acc / max(l, 1e-30).
//
// What bounds it: bytes. Each layer reads K and V for cur_len positions;
// at B=8, K=8, hd=128, bf16 and cur_len=1032 that is 33.9 MB, 0.0101 ms at
// 3.35 TB/s, against only 34 MFLOP.
//
// What this design does about it: the whole card reads the cache. The
// grid is (K, B, n_split): a block reads rows_per_split consecutive
// positions of one (batch, kv head), every cache byte once, with 16-byte
// vector loads, and serves all G = H/K query heads of that kv head (no
// repeated kv heads, as the TPU kernel's (K, G) contraction). The caller
// plans n_split for about two blocks per SM (kernels/decode_attn.py::
// plan_splits): at B=8, K=8 one block per (batch, kv head) would fill 64 of
// 132 SMs. Inside a block, a group of hd*size/16 lanes splits one cache
// row; the 8 warps interleave positions, and each lane keeps U rows of K
// and V in flight as raw 16-byte vectors before widening them, so each SM
// has enough loads outstanding to stream at the memory's rate. Each lane
// group keeps its own online-softmax state, merged by shuffles within the
// warp and through shared memory across warps. A block then writes its
// partial (m, l, acc[G][hd]) in fp32 to scratch, and a second small grid in
// the same call merges the n_split partials with the same max-rescale
// algebra and writes o. The merge is a second grid because blocks run in
// no order and cannot wait for each other; it reads 1 KB per (batch, head)
// at the serve shape. With n_split == 1 the first grid writes o itself and
// the merge is not launched.
//
// head_dim 112 (zamba2-7b's) runs the lane mapping of hd 128: 16 lanes a
// bf16 row (32 in fp32), of which the last 2 (4) load nothing and hold
// zeros, so the lane groups still tile the warp; only the first 112
// columns of the partials and of o are written. head_dim 80 (gpt2-2.7b's)
// runs the same mapping with 10 of the 16 bf16 lanes live (20 of 32 in
// fp32): 3/8 of the lanes idle, and the merge grid one thread a column.
//
// head_dim 256 (gemma-2b's): a bf16 row is one 16-byte vector a lane over
// the whole warp; an fp32 row would need 64 lanes, so each lane loads two
// vectors, 128 columns apart (NV = 2), and one warp still reads one row.
// The warps' partials then take G * 256 * 8 * 4 bytes of shared memory (64
// KB at G = 8), above the 48 KB a block gets without asking, so the block's
// shared memory is dynamic, raised once per instantiation where it needs
// more.
//
// Groups: G = H/K is 1, 2, 4, 6 or 8 (6: internvl2-26b's and
// nemotron-4-15b's 48 q heads on 8 kv heads). G > 4 keeps 2 rows in flight
// a lane instead of 4, for registers; at G = 6 and head_dim 256 the warps'
// partials take 49,536 bytes, which also goes the dynamic way. The merge
// grid finds a q head's kv head and member as h / G and h % G, which holds
// for a G that is not a power of two.
//
// The block form. Given lse (fp32, (B, H)), the call returns what a rank
// holding one block of the cache's positions needs to merge with the
// others': o in fp32 (B, 1, H, hd), normalised over this block alone, and
// lse = m + log(l), the log of its softmax denominator. Both grids compute
// m and l anyway; only the outputs differ.

#include "common.cuh"

namespace repro {
namespace {

constexpr int DWARPS = 8;
constexpr int DT = DWARPS * 32;

// The block's geometry; kernels/decode_attn.py::rows_per_step mirrors STEP.
template <typename T, int HD, int G>
struct DecodeShape {
  static constexpr int VEC = Vec16<T>::N;               // elements per 16-byte load
  static constexpr int NV = HD / VEC > 32 ? HD / (32 * VEC) : 1;   // loads per lane a row
  static constexpr int E = VEC * NV;                    // elements a lane holds of a row
  static constexpr int LPR = HD / E;                    // lanes per cache row
  static constexpr int RPW = 32 / LPR;                  // rows per warp per load
  static constexpr int U = G <= 4 ? 4 : 2;              // rows in flight per lane
  static constexpr int STEP = DWARPS * RPW * U;         // positions per block step
  static_assert(LPR >= 1 && LPR <= 32 && LPR * E == HD, "head_dim does not fit one warp");
  // the warps' partials in dynamic shared memory: acc [DWARPS][G][HD], m and l [DWARPS][G]
  static constexpr int SMEM = (DWARPS * G * HD + 2 * DWARPS * G) * 4;
};

// column of element e of load j of the lane at chunk cl
template <int VEC, int LPR>
__device__ __forceinline__ int column(int cl, int j, int e) { return (j * LPR + cl) * VEC + e; }

// Element d of (batch, q head) bh of the output: o in T, or o in fp32 and
// its log-sum-exp where lse is given (the block form).
template <typename T>
__device__ __forceinline__ void store_out(void* o, float* lse, long long bh, int hdv, int d,
                                          float value, float log_sum) {
  if (lse == nullptr) {
    static_cast<T*>(o)[bh * hdv + d] = from_float<T>(value);
  } else {
    static_cast<float*>(o)[bh * hdv + d] = value;
    if (d == 0) lse[bh] = log_sum;
  }
}

// HD: the lane-mapping instantiation; HDV: the tensors' head_dim (HD, or
// 80 or 112 on the 128 mapping)
template <typename T, int HD, int G, int HDV>
__global__ void __launch_bounds__(DT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, void* __restrict__ o, float* __restrict__ lse,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int H, int K, int cur_len, int rows_per_split,
                    long long q_sb, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    float scale) {
  using S = DecodeShape<T, HD, G>;
  constexpr int VEC = S::VEC, NV = S::NV, E = S::E, LPR = S::LPR, RPW = S::RPW, U = S::U;

  extern __shared__ float decode_smem[];
  float* sm_acc = decode_smem;                          // [DWARPS][G][HD]
  float* sm_m = sm_acc + DWARPS * G * HD;               // [DWARPS][G]
  float* sm_l = sm_m + DWARPS * G;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rg = lane / LPR;                // row within the warp's load
  const int cl = lane % LPR;                // chunk of head_dim
  bool live[NV];                            // a load past the row's end reads nothing
#pragma unroll
  for (int j = 0; j < NV; ++j) live[j] = column<VEC, LPR>(cl, j, 0) < HDV;
  const int start = split * rows_per_split;
  const int end = min(cur_len, start + rows_per_split);

  float qf[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (live[j]) {
        Vec16<T>::load(q + b * q_sb + (kvh * G + g) * q_sh + column<VEC, LPR>(cl, j, 0),
                       qf[g] + j * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[g][j * VEC + e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) qf[g][e] *= scale;
  }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kb = kc + b * k_sb + kvh * k_sh;
  const T* vb = vc + b * v_sb + kvh * v_sh;

  for (int base = start; base < end; base += S::STEP) {
    uint4 kr[U][NV], vr[U][NV];             // raw rows in flight
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + (u * DWARPS + warp) * RPW + rg;
      valid[u] = pos < end;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int d = column<VEC, LPR>(cl, j, 0);
        if (valid[u] && live[j]) {
          kr[u][j] = *reinterpret_cast<const uint4*>(kb + pos * k_st + d);
          vr[u][j] = *reinterpret_cast<const uint4*>(vb + pos * v_st + d);
        } else {
          kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E], vf[E];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        Vec16<T>::widen(kr[u][j], kf + j * VEC);
        Vec16<T>::widen(vr[u][j], vf + j * VEC);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qf[g][e], kf[e], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)   // within the row's lanes
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid[u]) {
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(acc[g][e], corr, p * vf[e]);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the lane groups of this warp that hold the same head_dim chunk
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float m_new = fmaxf(m[g], mo);
      const float ca = expf(m[g] - m_new);
      const float cb = expf(mo - m_new);
      l[g] = l[g] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = m_new;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[(warp * G + g) * HD + column<VEC, LPR>(cl, j, e)] = acc[g][j * VEC + e];
      }
      if (cl == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; then o (contiguous (B, 1, H, HDV): q's dtype, or fp32
  // beside lse) or this split's partial, record ((b*K + kvh)*n_split +
  // split)*G + g
  for (int idx = threadIdx.x; idx < G * HDV; idx += DT) {
    const int g = idx / HDV;
    const int d = idx % HDV;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) {
      const float c = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * c;
      a += sm_acc[(w * G + g) * HD + d] * c;
    }
    if (n_split == 1) {
      const long long bh = (long long)b * H + kvh * G + g;
      store_out<T>(o, lse, bh, HDV, d, a / fmaxf(lsum, 1e-30f), mx + logf(lsum));
    } else {
      const long long rec = ((long long)(b * K + kvh) * n_split + split) * G + g;
      part_acc[rec * HDV + d] = a;
      if (d == 0) {
        part_ml[2 * rec] = mx;
        part_ml[2 * rec + 1] = lsum;
      }
    }
  }
}

// One block per (batch, q head), one thread per head_dim element: merge
// the n_split partials of its kv head's group member.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                    void* __restrict__ o, float* __restrict__ lse, int H, int G, int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int K = H / G;
  const int d = threadIdx.x;
  const long long rec0 = (long long)(b * K + h / G) * n_split * G + h % G;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_ml[2 * (rec0 + s * G)]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long rec = rec0 + s * G;
    const float c = expf(part_ml[2 * rec] - mx);
    lsum += part_ml[2 * rec + 1] * c;
    a += part_acc[rec * HD + d] * c;
  }
  store_out<T>(o, lse, bh, HD, d, a / fmaxf(lsum, 1e-30f), mx + logf(lsum));
}

template <typename T, int HD, int G, int HDV>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o, float* lse,
                          float* part, int B, int H, int K, int cur_len,
                          int n_split, int rows_per_split,
                          const long long* qs, const long long* ks,
                          const long long* vs, float scale, cudaStream_t st) {
  using S = DecodeShape<T, HD, G>;
  float* part_acc = part;
  float* part_ml = part + (long long)B * K * n_split * G * HDV;
  if (S::SMEM > 48 * 1024) {
    static bool raised = false;           // once per instantiation (one device a process)
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_split_kernel<T, HD, G, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          S::SMEM);
      if (err != cudaSuccess) return err;
      raised = true;
    }
  }
  decode_split_kernel<T, HD, G, HDV><<<dim3(K, B, n_split), DT, S::SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, lse, part_acc, part_ml,
      H, K, cur_len, rows_per_split,
      qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_merge_kernel<T, HDV><<<B * H, HDV, 0, st>>>(part_acc, part_ml, o, lse, H, G, n_split);
  return cudaGetLastError();
}

template <typename T, int HD, int HDV = HD>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       void* o, float* lse, float* part, int B, int H, int K, int cur_len,
                       int n_split, int rows, const long long* qs,
                       const long long* ks, const long long* vs, float scale,
                       cudaStream_t st) {
  switch (G) {
    case 1: return launch_decode<T, HD, 1, HDV>(q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 2: return launch_decode<T, HD, 2, HDV>(q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 4: return launch_decode<T, HD, 4, HDV>(q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 6: return launch_decode<T, HD, 6, HDV>(q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 8: return launch_decode<T, HD, 8, HDV>(q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, int G, const void* q, const void* k,
                        const void* v, void* o, float* lse, float* part, int B, int H, int K,
                        int cur_len, int n_split, int rows, const long long* qs,
                        const long long* ks, const long long* vs, float scale,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 32: return dispatch_g<T, 32>(G, q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 64: return dispatch_g<T, 64>(G, q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 80: return dispatch_g<T, 128, 80>(G, q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 112: return dispatch_g<T, 128, 112>(G, q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 128: return dispatch_g<T, 128>(G, q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 256: return dispatch_g<T, 256>(G, q, k, v, o, lse, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. q is (B, 1, H, hd) with strides
// (q_sb, q_sh) for batch and head; the caches are (B, T, K, hd) with
// strides for batch, position and kv head; head_dim has stride 1. o is a
// contiguous (B, 1, H, hd) buffer: in q's dtype where lse is null, else in
// fp32 beside lse, a contiguous fp32 (B, H) buffer for the log-sum-exps
// (the block form). The cache's first cur_len positions are read in
// n_split splits of rows_per_split (the last one shorter), none empty; with
// n_split > 1, part is fp32 scratch of B*K*n_split*G*(hd + 2) floats, else
// unused. 1 <= cur_len <= T is checked by the caller. Returns
// cudaGetLastError() after the launches.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, void* part, int dtype,
    int B, int H, int K, int hd, int cur_len, int n_split, int rows_per_split,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, void* stream) {
  const long long qs[2] = {q_sb, q_sh};
  const long long ks[3] = {k_sb, k_st, k_sh};
  const long long vs[3] = {v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* l = static_cast<float*>(lse);
  const int G = H / K;
  if (dtype == 0)
    return (int)repro::dispatch_hd<float>(hd, G, q, k, v, o, l, p, B, H, K, cur_len, n_split,
                                          rows_per_split, qs, ks, vs, scale, st);
  if (dtype == 1)
    return (int)repro::dispatch_hd<__nv_bfloat16>(hd, G, q, k, v, o, l, p, B, H, K, cur_len,
                                                  n_split, rows_per_split, qs, ks, vs,
                                                  scale, st);
  return (int)cudaErrorInvalidValue;
}
