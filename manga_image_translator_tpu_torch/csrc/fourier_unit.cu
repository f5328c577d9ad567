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
// transforms at FFT-minimal cost 0.22 GFLOP, against 13.2 MB of bf16 input
// and output: about 16 us at the 165 TFLOP/s of three TF32 tensor-core
// passes (the card's fastest f32-accurate rate) and 3.9 us of bytes.
//
// Design: five launches of one GEMM kernel, C the contiguous axis in
// every one of them, so nothing is transposed:
//   1. W stage:   per (n, h)  (2K x W)  . (W x C)     -> spectrum (re | im)
//   2. H stage:   per (n, k)  (2H x 2H) . (2H x C)    -> spectrum
//   3. conv:      (N H K x 2C) . (2C x 2C) + bias, ReLU
//   4. inverse H: per (n, k)  (2H x 2H) . (2H x C)
//   5. inverse W: per (n, h)  (W x 2K)  . (2K x C)    -> out, x's dtype
// The DFTs are dense products against twiddle tables built in float64 on
// the host (any H and W, odd ones included; no radix constraint; rows
// padded with zeros to a multiple of 4 floats for 16-byte copies). The
// spectra live in device memory as (N, H, K, 2C) f32 with the real parts
// in channels [0, C) and the imaginary parts in [C, 2C) (6.4 MB each at a
// 1024^2 crop: L2-resident between launches). A row of the stacked
// (re; im) axis r maps to (r % R) * stride_lo + (r / R) * stride_hi, so one
// kernel reads and writes every stage's view; a block keeps its B rows'
// offsets in shared memory.
//
// The products run on the tensor cores at f32 accuracy as 3xTF32
// (mma.sync m16n8k8): each f32 operand splits into hi = tf32(a) and
// lo = tf32(a - hi), and a.b = ah.bl + al.bh + ah.bh, accumulated in f32
// (TF32 alone keeps ~3 digits). A bf16 operand (x in stage 1) is exact in
// TF32, so that stage needs two passes. A block computes a 64 x 64 output
// tile with 4 warps of 32 x 32; its A and B tiles (16 deep) come through a
// 3-deep cp.async ring, so the next tiles load while this one computes;
// the epilogue (bias + ReLU for the conv, the cast for stage 5) stores
// pairs of columns straight from the accumulators. The wrapper allocates
// both spectra in one buffer.
//
// Times (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 0.188 ms at
// (6, 32, 80, 192) bf16 (cuFFT + einsum 0.276, bound 0.0151) and 0.238 ms
// at (1, 128, 128, 192) (0.338, bound 0.0162); the f32-FMA GEMM it
// replaced took 0.384 and 0.523 ms (timed one call per event pair).
// chip_smoke.py's lama_trace line splits a forward's K4 time by stage
// (k4_us_by_stage): the DFT stages are short batched GEMMs of 4-6 k-steps
// a block.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mit::bf16;

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 128, STAGES = 3;
constexpr int AS = BK + 4;       // A tile row stride (floats): no conflicts
constexpr int BS = BN + 8;       // B tile row stride (elements)
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// C[batch] (m x n) = A (m x k, row-major, lda a multiple of 4, shared by
// the batch) . B[batch] (k x n); rows of B and C through their Maps,
// columns contiguous (n a multiple of 8).
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

// 64 x 64 output tile per block; warp w owns rows (w / 2) * 32 and columns
// (w % 2) * 32: 2 x 4 m16n8 tiles. SPLIT_B: B is f32 and needs its lo part
// (a bf16 B is exact in TF32).
template <typename TB, typename TC>
__global__ void __launch_bounds__(THREADS) fu_gemm_tf32x3(Gemm g) {
  constexpr bool SPLIT_B = sizeof(TB) == 4;
  constexpr int EPC = 16 / sizeof(TB);          // B elements per 16 bytes
  __shared__ __align__(16) float as[STAGES][BM * AS];
  __shared__ __align__(16) TB bs[STAGES][BK * BS];
  __shared__ long long brow[MAX_ROWS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const TB* bp = static_cast<const TB*>(g.b) + at(g.b_batch, blockIdx.z);
  TC* cp = static_cast<TC*>(g.c) + at(g.c_batch, blockIdx.z);
  for (int r = tid; r < g.k; r += THREADS) brow[r] = at(g.b_row, r);
  __syncthreads();

  auto issue = [&](int kt) {
    const int k0 = kt * BK, st = kt % STAGES;
    for (int i = tid; i < BM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), cc = (i % (BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + cc;
      const int valid = gm < g.m ? max(0, min(4, g.k - gk)) : 0;
      const float* src = valid ? g.a + (long long)gm * g.lda + gk : g.a;
      mit::cp_async<16>(&as[st][r * AS + cc], src, valid * 4);
    }
    for (int i = tid; i < BK * (BN / EPC); i += THREADS) {
      const int r = i / (BN / EPC), cc = (i % (BN / EPC)) * EPC;
      const int gk = k0 + r, gn = n0 + cc;
      const int valid = gk < g.k ? max(0, min(EPC, g.n - gn)) : 0;
      const TB* src = valid ? bp + brow[gk] + gn : bp;
      mit::cp_async<16>(&bs[st][r * BS + cc], src,
                        valid * (int)sizeof(TB));
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (g.k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    mit::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
    mit::cp_commit();
    mit::cp_wait<STAGES - 1>();
    __syncthreads();
    const float* A = as[kt % STAGES];
    const TB* B = bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = A + (wm + mt * 16 + gq) * AS + kk + t;
        const float v[4] = {p[0], p[8 * AS], p[4], p[8 * AS + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) mit::split_tf32(v[e], ah[mt][e], al[mt][e]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const TB* p = B + (kk + t) * BS + wn + nt * 8 + gq;
        const float v[2] = {to_f(p[0]), to_f(p[4 * BS])};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (SPLIT_B)
            mit::split_tf32(v[e], bh[nt][e], bl[nt][e]);
          else
            bh[nt][e] = __float_as_uint(v[e]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // small terms first
          if (SPLIT_B) mit::mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
          mit::mma_tf32(acc[mt][nt], al[mt], bh[nt]);
          mit::mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm + mt * 16 + gq + half * 8;
      if (gm >= g.m) continue;
      TC* row = cp + at(g.c_row, gm);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + wn + nt * 8 + t * 2;
        if (gn >= g.n) continue;
        float v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
        if (g.bias != nullptr) {
          v0 = fmaxf(v0 + g.bias[gn], 0.f);
          v1 = fmaxf(v1 + g.bias[gn + 1], 0.f);
        }
        mit::store2(row + gn, v0, v1);
      }
    }
}

Map linear(long long stride) { return Map{LINEAR, stride, 0}; }

int lda_of(int k) { return (k + 3) & ~3; }

template <typename TB, typename TC>
cudaError_t run(const Gemm& g, int batch, cudaStream_t stream) {
  dim3 grid((g.m + BM - 1) / BM, (g.n + BN - 1) / BN, batch);
  fu_gemm_tf32x3<TB, TC><<<grid, THREADS, 0, stream>>>(g);
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
  g = Gemm{2 * k, c, w, fwd_w, lda_of(w), x, linear(c),
           linear((long long)w * c), s0, w_axis, linear((long long)k * c2),
           nullptr};
  if ((e = run<T, float>(g, n * h, stream)) != cudaSuccess) return e;
  // 2. forward H stage
  g = Gemm{2 * h, c, 2 * h, fwd_h, lda_of(2 * h), s0, h_axis, per_nk,
           s1, h_axis, per_nk, nullptr};
  if ((e = run<float, float>(g, n * k, stream)) != cudaSuccess) return e;
  // 3. spectral 1x1 conv + bias + ReLU over every (n, h, k) position
  g = Gemm{n * h * k, (int)c2, (int)c2, s1, (int)c2, wq, linear(c2),
           linear(0), s0, linear(c2), linear(0), bq};
  if ((e = run<float, float>(g, 1, stream)) != cudaSuccess) return e;
  // 4. inverse H stage
  g = Gemm{2 * h, c, 2 * h, inv_h, lda_of(2 * h), s0, h_axis, per_nk,
           s1, h_axis, per_nk, nullptr};
  if ((e = run<float, float>(g, n * k, stream)) != cudaSuccess) return e;
  // 5. inverse W stage (c2r), written in x's dtype
  g = Gemm{w, c, 2 * k, inv_w, lda_of(2 * k), s1, w_axis,
           linear((long long)k * c2), out, linear(c),
           linear((long long)w * c), nullptr};
  return run<float, T>(g, n * h, stream);
}

}  // namespace

// Tables as ops/fourier_unit.py builds them, each row padded to a multiple
// of 4 floats; c a multiple of 8; s0 and s1 (N, H, K, 2C) f32 each.
extern "C" int mit_fourier_unit(const void* x, void* out, const float* wq,
                                const float* bq, const float* fwd_w,
                                const float* fwd_h, const float* inv_h,
                                const float* inv_w, float* s0, float* s1,
                                int n, int h, int w, int c, int is_bf16,
                                cudaStream_t stream) {
  if (2 * h > MAX_ROWS || w > MAX_ROWS || 2 * (w / 2 + 1) > MAX_ROWS ||
      2 * c > MAX_ROWS || c % 8 != 0)
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
