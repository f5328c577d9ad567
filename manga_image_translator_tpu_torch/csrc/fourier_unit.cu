// K4: LaMa FourierUnit for Hopper (sm_90a).
//
// Replaces: manga_image_translator_tpu/ops/pallas_spectral.py,
//   fourier_unit_cm and fourier_unit_cm3 (the same function; cm3 splits
//   f32 products into bf16 passes for the TPU's matrix unit).
//
// Computes, over a channels-last (N, H, W, C) tensor,
//   out = irfft2(relu(S @ Wq + bq), s=(H, W), 'ortho'),  S = rfft2(x, 'ortho')
// where the 1x1 spectral conv Wq (2C x 2C) and bias bq are already
// de-interleaved into the [re | im] channel order (ops/fourier_unit.py).
//
// What bounds it on the H100: operations. At a 1024^2 crop (C = 192,
// H = W = 128) the spectral conv is 2.45 GFLOP and the two real 2-D
// transforms at FFT-minimal cost 0.22 GFLOP, against 25.8 MB of f32 input
// and output: about 16 us at the 165 TFLOP/s of three TF32 tensor-core
// passes (the card's fastest f32-accurate rate) and 7.7 us of bytes.
//
// Design: five launches of one f32 GEMM kernel, C the contiguous axis in
// every one of them, so nothing is transposed:
//   1. W stage:   per (n, h)  (2K x W)  . (W x C)     -> spectrum (re | im)
//   2. H stage:   per (n, k)  (2H x 2H) . (2H x C)    -> spectrum
//   3. conv:      (N H K x 2C) . (2C x 2C) + bias, ReLU
//   4. inverse H: per (n, k)  (2H x 2H) . (2H x C)
//   5. inverse W: per (n, h)  (W x 2K)  . (2K x C)    -> out, x's dtype
// The DFTs are dense products against twiddle tables built in float64 on
// the host (any H and W, odd ones included; no radix constraint). The
// spectra live in device memory as (N, H, K, 2C) f32 with the real parts in
// channels [0, C) and the imaginary parts in [C, 2C) (6.4 MB each at a
// 1024^2 crop: L2-resident between launches). A row of the stacked (re; im)
// axis r maps to (r % R) * stride_lo + (r / R) * stride_hi, so one kernel
// reads and writes every stage's view; a block keeps its rows' offsets in
// shared memory. The arithmetic is plain f32 FMA on the CUDA cores: exact
// to f32 rounding (TF32 alone keeps ~3 digits), simple, and about an order
// of magnitude above the bound; the dense DFT also does ~20x the FFT's
// operations. 3xTF32 tensor-core passes and a radix-split transform are the
// levers for a later version.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mit::bf16;

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int MAX_ROWS = 1024;   // longest contraction a block's table holds
constexpr int LINEAR = 1 << 30;  // a Map whose index never wraps

// index i -> (i % d) * lo + (i / d) * hi (elements)
struct Map {
  int d;
  long long lo, hi;
};

__device__ __forceinline__ long long at(const Map& m, int i) {
  return (long long)(i % m.d) * m.lo + (long long)(i / m.d) * m.hi;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// C[batch] (m x n) = A (m x k, row-major, shared by the batch) . B[batch]
// (k x n); rows of B and C through their Maps, columns contiguous.
struct Gemm {
  int m, n, k;
  const float* a;
  int lda;
  const void* b;
  Map b_row, b_batch;
  void* c;
  Map c_row, c_batch;
  const float* bias;  // per column, followed by ReLU; or null
};

// 64x64 output tile per block, 4x4 per thread (4 consecutive rows x 4
// consecutive columns, so each k step reads two float4 from shared memory
// for 16 FMAs).
template <typename TB, typename TC>
__global__ void __launch_bounds__(THREADS) gemm(Gemm g) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN];
  __shared__ long long brow[MAX_ROWS];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const TB* bp = static_cast<const TB*>(g.b) + at(g.b_batch, blockIdx.z);
  TC* cp = static_cast<TC*>(g.c) + at(g.c_batch, blockIdx.z);
  for (int r = tid; r < g.k; r += THREADS) brow[r] = at(g.b_row, r);
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.k; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int am = idx / BK, ak = idx % BK;
      const int gm = m0 + am, gka = k0 + ak;
      as[ak][am] = (gm < g.m && gka < g.k)
                       ? g.a[(long long)gm * g.lda + gka] : 0.f;
      const int bk = idx / BN, bn = idx % BN;
      const int gkb = k0 + bk, gn = n0 + bn;
      bs[bk][bn] = (gkb < g.k && gn < g.n) ? load_f(bp + brow[gkb] + gn)
                                           : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= g.m) continue;
    TC* row = cp + at(g.c_row, gm);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= g.n) continue;
      float v = acc[i][j];
      if (g.bias != nullptr) v = fmaxf(v + g.bias[gn], 0.f);
      store_f(row + gn, v);
    }
  }
}

Map linear(long long stride) { return Map{LINEAR, stride, 0}; }

template <typename TB, typename TC>
cudaError_t run(const Gemm& g, int batch, cudaStream_t stream) {
  dim3 grid((g.m + BM - 1) / BM, (g.n + BN - 1) / BN, batch);
  gemm<TB, TC><<<grid, THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fourier_unit(const T* x, T* out, const float* wq,
                         const float* bq, const float* fwd_w,
                         const float* fwd_h, const float* inv_h,
                         const float* inv_w, float* s0, float* s1, int n,
                         int h, int w, int c, cudaStream_t stream) {
  const int k = w / 2 + 1;
  const long long c2 = 2LL * c;
  // the stacked (re; im) axis of a spectrum row: index r < R is the real
  // part of row r, index r >= R the imaginary part of row r - R
  const Map w_axis{k, c2, c};                       // over 2K, per (n, h)
  const Map h_axis{h, (long long)k * c2, c};        // over 2H, per (n, k)
  const Map per_nk{k, c2, (long long)h * k * c2};   // batch n * K + k
  cudaError_t e;

  Gemm g{};
  // 1. forward W stage
  g = Gemm{2 * k, c, w, fwd_w, w, x, linear(c), linear((long long)w * c),
           s0, w_axis, linear((long long)k * c2), nullptr};
  if ((e = run<T, float>(g, n * h, stream)) != cudaSuccess) return e;
  // 2. forward H stage
  g = Gemm{2 * h, c, 2 * h, fwd_h, 2 * h, s0, h_axis, per_nk,
           s1, h_axis, per_nk, nullptr};
  if ((e = run<float, float>(g, n * k, stream)) != cudaSuccess) return e;
  // 3. spectral 1x1 conv + bias + ReLU over every (n, h, k) position
  g = Gemm{n * h * k, (int)c2, (int)c2, s1, (int)c2, wq, linear(c2),
           linear(0), s0, linear(c2), linear(0), bq};
  if ((e = run<float, float>(g, 1, stream)) != cudaSuccess) return e;
  // 4. inverse H stage
  g = Gemm{2 * h, c, 2 * h, inv_h, 2 * h, s0, h_axis, per_nk,
           s1, h_axis, per_nk, nullptr};
  if ((e = run<float, float>(g, n * k, stream)) != cudaSuccess) return e;
  // 5. inverse W stage (c2r), written in x's dtype
  g = Gemm{w, c, 2 * k, inv_w, 2 * k, s1, w_axis,
           linear((long long)k * c2), out, linear(c),
           linear((long long)w * c), nullptr};
  return run<float, T>(g, n * h, stream);
}

}  // namespace

extern "C" int mit_fourier_unit(const void* x, void* out, const float* wq,
                                const float* bq, const float* fwd_w,
                                const float* fwd_h, const float* inv_h,
                                const float* inv_w, float* s0, float* s1,
                                int n, int h, int w, int c, int is_bf16,
                                cudaStream_t stream) {
  if (2 * h > MAX_ROWS || w > MAX_ROWS || 2 * (w / 2 + 1) > MAX_ROWS ||
      2 * c > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)fourier_unit<bf16>(static_cast<const bf16*>(x),
                                   static_cast<bf16*>(out), wq, bq, fwd_w,
                                   fwd_h, inv_h, inv_w, s0, s1, n, h, w, c,
                                   stream);
  return (int)fourier_unit<float>(static_cast<const float*>(x),
                                  static_cast<float*>(out), wq, bq, fwd_w,
                                  fwd_h, inv_h, inv_w, s0, s1, n, h, w, c,
                                  stream);
}
