// GQA decode attention (one query token against the KV cache) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn.py
// (_decode_kernel, launched by decode_attention), which the reference model
// computes with models/attention.py::decode_attention in
// self_attention_decode. Same math as the TPU kernel: positions >= cur_len
// are never read, an online softmax per (kv head, group member) in fp32
// throughout, output acc / max(l, 1e-30).
//
// What bounds it: bytes. Each layer reads K and V for cur_len positions;
// at B=8, K=8, hd=128, bf16 and cur_len=1032 that is 33.8 MB, 10 us at
// 3.35 TB/s, against only 34 MFLOP.
//
// What this design does about it: every cache byte is read once, with
// 16-byte vector loads, by one block per (batch, kv head) that serves all
// G = H/K query heads of that kv head (no repeated kv heads, as the TPU
// kernel's (K, G) contraction). A group of hd*size/16 lanes splits one
// cache row; the 8 warps interleave positions and keep U rows of K and V
// in flight per lane before using them. Each lane group keeps its own
// online-softmax state, merged at the end by shuffles within the warp and
// through shared memory across warps. At B=8, K=8 this is only 64 blocks
// for 132 SMs: splitting T over more blocks (split-K) is later work.

#include "common.cuh"

namespace repro {
namespace {

constexpr int DWARPS = 8;
constexpr int DT = DWARPS * 32;

template <typename T, int HD, int G>
__global__ void __launch_bounds__(DT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, T* __restrict__ o,
              int H, int K, int cur_len,
              long long q_sb, long long q_sh,
              long long k_sb, long long k_st, long long k_sh,
              long long v_sb, long long v_st, long long v_sh,
              float scale) {
  constexpr int VEC = Vec16<T>::N;          // elements per 16-byte load
  constexpr int LPR = HD / VEC;             // lanes per cache row
  constexpr int RPW = 32 / LPR;             // rows per warp per step
  constexpr int U = G >= 4 ? 2 : 4;         // rows in flight per lane
  static_assert(LPR >= 1 && LPR <= 32, "head_dim does not fit one warp");

  __shared__ float sm_acc[DWARPS][G][HD];
  __shared__ float sm_m[DWARPS][G];
  __shared__ float sm_l[DWARPS][G];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rg = lane / LPR;                // row within the warp step
  const int cl = lane % LPR;                // chunk of head_dim
  const int d0 = cl * VEC;

  float qf[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Vec16<T>::load(q + b * q_sb + (kvh * G + g) * q_sh + d0, qf[g]);
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
  constexpr int STEP = DWARPS * RPW * U;    // positions per block iteration

  for (int base = 0; base < cur_len; base += STEP) {
    float kf[U][VEC], vf[U][VEC];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + (u * DWARPS + warp) * RPW + rg;
      valid[u] = pos < cur_len;
      if (valid[u]) {
        Vec16<T>::load(kb + pos * k_st, kf[u]);
        Vec16<T>::load(vb + pos * v_st, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qf[g][e], kf[u][e], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)   // within the row's lanes
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid[u]) {
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(acc[g][e], corr, p * vf[u][e]);
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

  // merge the warps; o is contiguous (B, 1, H, HD)
  for (int idx = threadIdx.x; idx < G * HD; idx += DT) {
    const int g = idx / HD;
    const int d = idx % HD;
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
    o[((long long)b * H + kvh * G + g) * HD + d] = from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int G>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o,
                          int B, int H, int K, int cur_len,
                          const long long* qs, const long long* ks,
                          const long long* vs, float scale, cudaStream_t st) {
  decode_kernel<T, HD, G><<<dim3(K, B), DT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, K, cur_len,
      qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int K, int cur_len,
                       const long long* qs, const long long* ks,
                       const long long* vs, float scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch_decode<T, HD, 1>(q, k, v, o, B, H, K, cur_len, qs, ks, vs, scale, st);
    case 2: return launch_decode<T, HD, 2>(q, k, v, o, B, H, K, cur_len, qs, ks, vs, scale, st);
    case 4: return launch_decode<T, HD, 4>(q, k, v, o, B, H, K, cur_len, qs, ks, vs, scale, st);
    case 8: return launch_decode<T, HD, 8>(q, k, v, o, B, H, K, cur_len, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, int G, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int K,
                        int cur_len, const long long* qs, const long long* ks,
                        const long long* vs, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, o, B, H, K, cur_len, qs, ks, vs, scale, st);
    case 32: return dispatch_g<T, 32>(G, q, k, v, o, B, H, K, cur_len, qs, ks, vs, scale, st);
    case 64: return dispatch_g<T, 64>(G, q, k, v, o, B, H, K, cur_len, qs, ks, vs, scale, st);
    case 128: return dispatch_g<T, 128>(G, q, k, v, o, B, H, K, cur_len, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. q is (B, 1, H, hd) with strides
// (q_sb, q_sh) for batch and head; the caches are (B, T, K, hd) with
// strides for batch, position and kv head; head_dim has stride 1. o is a
// contiguous (B, 1, H, hd) buffer. 1 <= cur_len <= T is checked by the
// caller. Returns cudaGetLastError() after launch.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int K, int hd, int cur_len,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, void* stream) {
  const long long qs[2] = {q_sb, q_sh};
  const long long ks[3] = {k_sb, k_st, k_sh};
  const long long vs[3] = {v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  if (dtype == 0)
    return (int)repro::dispatch_hd<float>(hd, G, q, k, v, o, B, H, K, cur_len,
                                          qs, ks, vs, scale, st);
  if (dtype == 1)
    return (int)repro::dispatch_hd<__nv_bfloat16>(hd, G, q, k, v, o, B, H, K,
                                                  cur_len, qs, ks, vs, scale, st);
  return (int)cudaErrorInvalidValue;
}
