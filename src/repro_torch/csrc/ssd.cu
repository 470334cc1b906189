// Mamba2 SSD intra-chunk block for Hopper (sm_90a), fp32 inputs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py
// (_ssd_chunk_kernel, launched by ssd_intra_chunk), which stands where the
// reference model calls models/mamba2.py::ssd_chunked. Same function: for
// each chunk of Lc positions (the last one may be ragged) and each head h,
//   cs_i       = sum_{k<=i} dt_k a_h                    (fp32, in the kernel)
//   y_intra_i  = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//   state      = sum_j dt_j exp(cs_last - cs_j) B_j (x) x_j       (N x P)
//   decay      = exp(cs_last)
// y_intra is written in fp32 (the reference adds the intra- and inter-chunk
// terms in fp32 and casts once); states and decay are fp32 as on the TPU.
// Rows past the sequence end are read as zero (dt = 0 there), which equals
// the reference's zero padding of the last chunk; they are never written.
//
// It serves fp32 inputs, whose checks (2e-5 against the plain version)
// need full fp32 products: bf16 inputs go to the tensor-core kernel in
// ssd_wgmma.cu, which computes the whole SSD.
//
// What bounds it: at the serve shape (B=8, S=1000, H=80, P=64, N=128,
// Lc=256) the TPU kernel's inputs and outputs (x, dt, B, C, y_intra,
// states, decay) are ~420 MB in fp32 against ~22 GFLOP of causal work:
// 0.125 ms at 3.35 TB/s; the fp32 CUDA cores (67 TFLOP/s) floor it at 0.33 ms.
//
// What the design does about it: two grids in one launch call.
//  * ssd_intra_kernel, one block per (batch*chunk, 16-head tile, 64-row
//    tile of the chunk). It computes the causal C.B^T score tile (64 rows by
//    the columns up to the diagonal) once into shared memory and reuses it
//    for all 16 heads of the tile, as the TPU's head tile does; per head it
//    builds the decayed, dt-scaled 64x32 weight tile (pairs j > i are
//    skipped before the exp, which would overflow) and multiplies it into
//    x, register-tiled, accumulating y in registers. The cumsum of dt*a runs
//    in the block from dt staged in shared memory.
//  * ssd_state_kernel, one block per (batch*chunk, head, 64 state rows):
//    the chunk's end state B^T (w x) with w_j = dt_j exp(cs_last - cs_j),
//    and the chunk decay.
// Each input is read once per block from device memory or L2, every
// intermediate (scores, decay weights, cumsum) stays on chip.

#include <atomic>

#include "common.cuh"

namespace repro {
namespace {

constexpr int NT = 256;          // threads: 16 row groups (ty) x 16 lanes (tx)
constexpr int BI = 64;           // chunk rows per block (intra kernel)
constexpr int BJ = 64;           // score columns per tile (phase A)
constexpr int BJ2 = 32;          // weight columns per tile (phase B)
constexpr int KN = 32;           // state columns per staged B / C tile
constexpr int HT = 16;           // heads per block (intra kernel)
constexpr int BN = 64;           // state rows per block (state kernel)
constexpr int BJS = 32;          // chunk rows per tile (state kernel)
constexpr int MAX_LC = 256;      // the wrapper refuses longer chunks
constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is cached

// Copy rows r < nrows of `ncols` elements (row r at src + r*row_stride)
// into shared memory; rows >= valid_rows and columns >= valid_cols are
// zero. ncols and valid_cols are multiples of the 16-byte vector.
__device__ __forceinline__ void stage(float* dst, int dst_stride, const float* src,
                                      long long row_stride, int nrows, int valid_rows,
                                      int ncols, int valid_cols) {
  constexpr int V = Vec16<float>::N;
  const int chunks = ncols / V;
  for (int idx = threadIdx.x; idx < nrows * chunks; idx += NT) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * V;
    float buf[V];
    if (r < valid_rows && c < valid_cols) {
      Vec16<float>::load(src + r * row_stride + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) buf[e] = 0.f;
    }
    float* out = dst + r * dst_stride + c;
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = buf[e];
  }
}

// VEC consecutive floats from shared memory.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

// Inclusive cumsum of dt_j * a over j < len by warp 0, from dt in shared
// memory (stride 1) into cs. Each lane sums a run of rows in order, then the
// runs' totals are scanned across the lanes. Callers synchronise after.
__device__ __forceinline__ void warp_cumsum(const float* dt, float a, int len, float* cs) {
  const int lane = threadIdx.x;
  const int per = (len + 31) / 32;
  const int r0 = min(len, lane * per);
  const int r1 = min(len, r0 + per);
  float run = 0.f;
  for (int j = r0; j < r1; ++j) {
    run += __fmul_rn(dt[j], a);   // da rounded first, as the reference
    cs[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int j = r0; j < r1; ++j) cs[j] += excl;
}

template <int P>
struct IntraSmem {
  // floats of the union region: phase A's C and B tiles, or phase B's x
  // and weight tiles
  static constexpr int a_floats = BI * (KN + 4) + BJ * (KN + 4);
  static constexpr int b_floats = BJ2 * P + BI * (BJ2 + 4);
  static constexpr int u_floats = a_floats > b_floats ? a_floats : b_floats;
  __host__ __device__ static int lc_pad(int lc) { return (lc + BJ - 1) / BJ * BJ; }
  __host__ __device__ static int ss(int lc) { return lc_pad(lc) + 4; }
  __host__ __device__ static int ds(int lc) { return lc_pad(lc) + 1; }
  __host__ __device__ static size_t bytes(int lc) {
    return sizeof(float) * (size_t)(BI * ss(lc) + u_floats + HT * ds(lc) + lc_pad(lc));
  }
};

template <int P>
__global__ void __launch_bounds__(NT)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y,
                 int S, int H, int N, int lc, int nc) {
  using Sm = IntraSmem<P>;
  constexpr int VEC = P >= 64 ? 4 : P / 16;   // output columns per vector
  constexpr int NJ = P / (16 * VEC);          // vectors per thread per row

  const int bc = blockIdx.x;
  const int b = bc / nc;
  const int start = (bc % nc) * lc;           // first position of the chunk
  const int len = min(lc, S - start);         // valid rows of the chunk
  const int h0 = blockIdx.y * HT;
  const int nh = min(HT, H - h0);
  const int i0 = blockIdx.z * BI;
  if (i0 >= len) return;                      // the tile is all padding
  const int rows = min(BI, len - i0);
  const int jend = i0 + rows;                 // causal: columns j < jend

  const int ss = Sm::ss(lc);
  const int ds = Sm::ds(lc);
  extern __shared__ float4 smem_raw[];
  float* sS = reinterpret_cast<float*>(smem_raw);   // BI x ss scores
  float* sU = sS + BI * ss;                         // union region
  float* sC = sU;                                   // BI x (KN+4)
  float* sB = sC + BI * (KN + 4);                   // BJ x (KN+4)
  float* sX = sU;                                   // BJ2 x P
  float* sA = sX + BJ2 * P;                         // BI x (BJ2+4)
  float* sDt = sU + Sm::u_floats;                   // HT x ds
  float* sCs = sDt + HT * ds;                       // lc_pad

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long row0 = (long long)b * S + start;  // sequence row of chunk row 0

  // dt of the tile's heads, rows j < jend
  for (int idx = tid; idx < jend * HT; idx += NT) {
    const int j = idx / HT;
    const int hh = idx % HT;
    sDt[hh * ds + j] = hh < nh ? dt[(row0 + j) * H + h0 + hh] : 0.f;
  }

  // phase A: scores S[i][j] = C_{i0+i} . B_j for j < jend, once for all heads
  const float* cb = cm + (row0 + i0) * N;
  const float* bb = bm + row0 * N;
  const int njt = (jend + BJ - 1) / BJ;
  for (int jt = 0; jt < njt; ++jt) {
    const int j0 = jt * BJ;
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int n0 = 0; n0 < N; n0 += KN) {
      __syncthreads();                        // previous tiles consumed
      stage(sC, KN + 4, cb + n0, N, BI, rows, KN, N - n0);
      stage(sB, KN + 4, bb + (long long)j0 * N + n0, N, BJ, len - j0, KN, N - n0);
      __syncthreads();
#pragma unroll
      for (int d = 0; d < KN; d += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(sC + (4 * ty + r) * (KN + 4) + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 bv = *reinterpret_cast<const float4*>(sB + (tx + 16 * c) * (KN + 4) + d);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[r][c] = fmaf(cv[r].x, bv.x, s[r][c]);
            s[r][c] = fmaf(cv[r].y, bv.y, s[r][c]);
            s[r][c] = fmaf(cv[r].z, bv.z, s[r][c]);
            s[r][c] = fmaf(cv[r].w, bv.w, s[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sS[(4 * ty + r) * ss + j0 + tx + 16 * c] = s[r][c];
  }

  // phase B: per head, y_i = sum_{j<=i} S[i][j] exp(cs_i - cs_j) dt_j x_j
  const int njt2 = (jend + BJ2 - 1) / BJ2;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* dth = sDt + hh * ds;
    __syncthreads();                          // sS, sDt written; last head done
    if (tid < 32) warp_cumsum(dth, a[h], jend, sCs);
    __syncthreads();

    float acc[4][P / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < P / 16; ++c) acc[r][c] = 0.f;

    for (int jt = 0; jt < njt2; ++jt) {
      const int j0 = jt * BJ2;
      stage(sX, P, x + ((row0 + j0) * H + h) * P, (long long)H * P, BJ2,
               len - j0, P, P);
      for (int e = tid; e < BI * BJ2; e += NT) {
        const int i = e / BJ2;
        const int gi = i0 + i;
        const int gj = j0 + e % BJ2;
        float w = 0.f;
        if (i < rows && gj <= gi)             // masked before the exp
          w = sS[i * ss + gj] * expf(sCs[gi] - sCs[gj]) * dth[gj];
        sA[i * (BJ2 + 4) + e % BJ2] = w;
      }
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < BJ2; k += 4) {
        float4 wv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wv[r] = *reinterpret_cast<const float4*>(sA + (4 * ty + r) * (BJ2 + 4) + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* xrow = sX + (k + kk) * P;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            float xv[VEC];
            load_vec<VEC>(xrow + VEC * tx + 16 * VEC * jj, xv);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float w = kk == 0 ? wv[r].x : kk == 1 ? wv[r].y : kk == 2 ? wv[r].z : wv[r].w;
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[r][jj * VEC + e] = fmaf(w, xv[e], acc[r][jj * VEC + e]);
            }
          }
        }
      }
      __syncthreads();
    }

    // y is contiguous (B, S, H, P), fp32
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      if (i >= rows) continue;
      float* yrow = y + ((row0 + i0 + i) * H + h) * P;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        float* dst = yrow + VEC * tx + 16 * VEC * jj;
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              acc[r][4 * jj], acc[r][4 * jj + 1], acc[r][4 * jj + 2], acc[r][4 * jj + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) dst[e] = acc[r][jj * VEC + e];
        }
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(NT)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ bm,
                 float* __restrict__ states, float* __restrict__ decay,
                 int S, int H, int N, int lc, int nc) {
  constexpr int VEC = P >= 64 ? 4 : P / 16;
  constexpr int NJ = P / (16 * VEC);
  __shared__ __align__(16) float sB[BJS * (BN + 4)];
  __shared__ __align__(16) float sX[BJS * P];
  __shared__ float sDt[MAX_LC];
  __shared__ float sCs[MAX_LC];

  const int bc = blockIdx.x;
  const int b = bc / nc;
  const int start = (bc % nc) * lc;
  const int len = min(lc, S - start);
  const int h = blockIdx.y;
  const int n0 = blockIdx.z * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long row0 = (long long)b * S + start;

  for (int j = tid; j < len; j += NT) sDt[j] = dt[(row0 + j) * H + h];
  __syncthreads();
  if (tid < 32) warp_cumsum(sDt, a[h], len, sCs);
  __syncthreads();
  const float last = sCs[len - 1];   // padded rows add dt = 0: the chunk's end
  if (blockIdx.z == 0 && tid == 0) decay[(long long)bc * H + h] = expf(last);

  float acc[4][P / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < P / 16; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < len; j0 += BJS) {
    const int valid = min(BJS, len - j0);
    __syncthreads();
    stage(sB, BN + 4, bm + (row0 + j0) * N + n0, N, BJS, valid, BN, N - n0);
    stage(sX, P, x + ((row0 + j0) * H + h) * P, (long long)H * P, BJS, valid, P, P);
    __syncthreads();
    // x_j *= w_j = dt_j exp(cs_last - cs_j)
    for (int e = tid; e < valid * P; e += NT) {
      const int j = e / P;
      sX[e] *= sDt[j0 + j] * expf(last - sCs[j0 + j]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < valid; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(sB + j * (BN + 4) + 4 * ty);
      const float bvals[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        float xv[VEC];
        load_vec<VEC>(sX + j * P + VEC * tx + 16 * VEC * jj, xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][jj * VEC + e] = fmaf(bvals[r], xv[e], acc[r][jj * VEC + e]);
      }
    }
  }

  // states is contiguous (B, NC, H, N, P)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + 4 * ty + r;
    if (n >= N) continue;
    float* srow = states + (((long long)bc * H + h) * N + n) * P;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VEC; ++e) srow[VEC * tx + 16 * VEC * jj + e] = acc[r][jj * VEC + e];
  }
}

template <int P>
cudaError_t launch_ssd(const float* x, const float* dt, const float* a, const float* bm,
                       const float* cm, float* y, float* states, float* decay,
                       int B, int S, int H, int N, int lc, cudaStream_t stream) {
  using Sm = IntraSmem<P>;
  auto intra = ssd_intra_kernel<P>;
  // above 48 KB of shared memory only after opting in, once per device and
  // instantiation, for the largest chunk the wrapper accepts
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(intra, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Sm::bytes(MAX_LC));
    if (err != cudaSuccess) return err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const int nc = (S + lc - 1) / lc;
  const dim3 grid_y(B * nc, (H + HT - 1) / HT, (lc + BI - 1) / BI);
  intra<<<grid_y, NT, Sm::bytes(lc), stream>>>(x, dt, a, bm, cm, y, S, H, N, lc, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_s(B * nc, H, (N + BN - 1) / BN);
  ssd_state_kernel<P><<<grid_s, NT, 0, stream>>>(x, dt, a, bm, states, decay,
                                                 S, H, N, lc, nc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// fp32 throughout, all tensors contiguous: x (B, S, H, P), dt (B, S, H),
// a (H,), B and C (B, S, N); outputs y (B, S, H, P), states (B, NC, H, N, P)
// and decay (B, NC, H), with NC = ceil(S / lc). 1 <= lc <= 256, N % 8 == 0,
// P in {16, 32, 64, 128}. Returns cudaGetLastError() after both launches.
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y, void* states,
                               void* decay, int B, int S, int H, int P, int N, int lc,
                               void* stream) {
  using repro::launch_ssd;
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  float* df = static_cast<float*>(decay);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lc < 1 || lc > repro::MAX_LC || N % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 16: return (int)launch_ssd<16>(xf, dtf, af, bf, cf, yf, sf, df, B, S, H, N, lc, st);
    case 32: return (int)launch_ssd<32>(xf, dtf, af, bf, cf, yf, sf, df, B, S, H, N, lc, st);
    case 64: return (int)launch_ssd<64>(xf, dtf, af, bf, cf, yf, sf, df, B, S, H, N, lc, st);
    case 128: return (int)launch_ssd<128>(xf, dtf, af, bf, cf, yf, sf, df, B, S, H, N, lc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
