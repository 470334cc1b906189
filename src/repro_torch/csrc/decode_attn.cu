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
// columns of the partials and of o are written.

#include "common.cuh"

namespace repro {
namespace {

constexpr int DWARPS = 8;
constexpr int DT = DWARPS * 32;

// The block's geometry; kernels/decode_attn.py::rows_per_step mirrors STEP.
template <typename T, int HD, int G>
struct DecodeShape {
  static constexpr int VEC = Vec16<T>::N;               // elements per 16-byte load
  static constexpr int LPR = HD / VEC;                  // lanes per cache row
  static constexpr int RPW = 32 / LPR;                  // rows per warp per load
  static constexpr int U = G <= 4 ? 4 : 2;              // rows in flight per lane
  static constexpr int STEP = DWARPS * RPW * U;         // positions per block step
  static_assert(LPR >= 1 && LPR <= 32, "head_dim does not fit one warp");
};

// HD: the lane-mapping instantiation; HDV: the tensors' head_dim (HD, or
// 112 on the 128 mapping)
template <typename T, int HD, int G, int HDV>
__global__ void __launch_bounds__(DT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, T* __restrict__ o,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int H, int K, int cur_len, int rows_per_split,
                    long long q_sb, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    float scale) {
  using S = DecodeShape<T, HD, G>;
  constexpr int VEC = S::VEC, LPR = S::LPR, RPW = S::RPW, U = S::U;

  __shared__ float sm_acc[DWARPS][G][HD];
  __shared__ float sm_m[DWARPS][G];
  __shared__ float sm_l[DWARPS][G];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rg = lane / LPR;                // row within the warp's load
  const int cl = lane % LPR;                // chunk of head_dim
  const int d0 = cl * VEC;
  const bool live = d0 < HDV;               // a lane past the row's end loads nothing
  const int start = split * rows_per_split;
  const int end = min(cur_len, start + rows_per_split);

  float qf[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (live) {
      Vec16<T>::load(q + b * q_sb + (kvh * G + g) * q_sh + d0, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) qf[g][e] *= scale;
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const T* kb = kc + b * k_sb + kvh * k_sh + d0;
  const T* vb = vc + b * v_sb + kvh * v_sh + d0;

  for (int base = start; base < end; base += S::STEP) {
    uint4 kr[U], vr[U];                     // raw rows in flight
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + (u * DWARPS + warp) * RPW + rg;
      valid[u] = pos < end;
      if (valid[u] && live) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + pos * k_st);
        vr[u] = *reinterpret_cast<const uint4*>(vb + pos * v_st);
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC], vf[VEC];
      Vec16<T>::widen(kr[u], kf);
      Vec16<T>::widen(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qf[g][e], kf[e], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)   // within the row's lanes
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid[u]) {
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(acc[g][e], corr, p * vf[e]);
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
      for (int e = 0; e < VEC; ++e) {
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
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
      if (cl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; then o (contiguous (B, 1, H, HDV)) or this split's
  // partial, record ((b*K + kvh)*n_split + split)*G + g
  for (int idx = threadIdx.x; idx < G * HDV; idx += DT) {
    const int g = idx / HDV;
    const int d = idx % HDV;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    if (n_split == 1) {
      o[((long long)b * H + kvh * G + g) * HDV + d] = from_float<T>(a / fmaxf(lsum, 1e-30f));
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
                    T* __restrict__ o, int H, int G, int n_split) {
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
  o[(long long)bh * HD + d] = from_float<T>(a / fmaxf(lsum, 1e-30f));
}

template <typename T, int HD, int G, int HDV>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o,
                          float* part, int B, int H, int K, int cur_len,
                          int n_split, int rows_per_split,
                          const long long* qs, const long long* ks,
                          const long long* vs, float scale, cudaStream_t st) {
  float* part_acc = part;
  float* part_ml = part + (long long)B * K * n_split * G * HDV;
  decode_split_kernel<T, HD, G, HDV><<<dim3(K, B, n_split), DT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), part_acc, part_ml,
      H, K, cur_len, rows_per_split,
      qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_merge_kernel<T, HDV><<<B * H, HDV, 0, st>>>(part_acc, part_ml, static_cast<T*>(o),
                                                     H, G, n_split);
  return cudaGetLastError();
}

template <typename T, int HD, int HDV = HD>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       void* o, float* part, int B, int H, int K, int cur_len,
                       int n_split, int rows, const long long* qs,
                       const long long* ks, const long long* vs, float scale,
                       cudaStream_t st) {
  switch (G) {
    case 1: return launch_decode<T, HD, 1, HDV>(q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 2: return launch_decode<T, HD, 2, HDV>(q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 4: return launch_decode<T, HD, 4, HDV>(q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 8: return launch_decode<T, HD, 8, HDV>(q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, int G, const void* q, const void* k,
                        const void* v, void* o, float* part, int B, int H, int K,
                        int cur_len, int n_split, int rows, const long long* qs,
                        const long long* ks, const long long* vs, float scale,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 32: return dispatch_g<T, 32>(G, q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 64: return dispatch_g<T, 64>(G, q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 112: return dispatch_g<T, 128, 112>(G, q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    case 128: return dispatch_g<T, 128>(G, q, k, v, o, part, B, H, K, cur_len, n_split, rows, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. q is (B, 1, H, hd) with strides
// (q_sb, q_sh) for batch and head; the caches are (B, T, K, hd) with
// strides for batch, position and kv head; head_dim has stride 1. o is a
// contiguous (B, 1, H, hd) buffer. The cache's first cur_len positions are
// read in n_split splits of rows_per_split (the last one shorter), none
// empty; with n_split > 1, part is fp32 scratch of B*K*n_split*G*(hd + 2)
// floats, else unused. 1 <= cur_len <= T is checked by the caller. Returns
// cudaGetLastError() after the launches.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, void* part, int dtype,
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
  const int G = H / K;
  if (dtype == 0)
    return (int)repro::dispatch_hd<float>(hd, G, q, k, v, o, p, B, H, K, cur_len, n_split,
                                          rows_per_split, qs, ks, vs, scale, st);
  if (dtype == 1)
    return (int)repro::dispatch_hd<__nv_bfloat16>(hd, G, q, k, v, o, p, B, H, K, cur_len,
                                                  n_split, rows_per_split, qs, ks, vs,
                                                  scale, st);
  return (int)cudaErrorInvalidValue;
}
