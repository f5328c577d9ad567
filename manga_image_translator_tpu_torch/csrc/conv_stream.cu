// K5: streaming stride-1 VALID NHWC convolution for Hopper (sm_90a).
//
// Replaces: manga_image_translator_tpu/ops/pallas_conv.py, conv2d_stream
//   (_conv_call, body _conv_kernel).
//
// Computes out[n, y, x, o] = act(bias[o] + sum_{dy, dx, i}
//   x[n, y + dy, x + dx, i] * w[dy, dx, i, o]) over an input the caller has
// already padded, HWIO weights, f32 accumulation, with bias, ReLU and the
// cast to the output dtype fused into the epilogue. On the LaMa path it
// runs the stem (reflect-padded 7x7, 4 -> 64, ReLU) and the final conv
// (reflect-padded 7x7, 64 -> 3).
//
// What bounds it on the H100: bytes. At a 1024^2 crop in bf16 the stem
// moves 143 MB (almost all of it the 64-channel output) against 26 GFLOP,
// the final conv 148 MB against 20 GFLOP: ~43 us of bytes each, above
// their bf16 tensor-core time.
//
// Design: a direct (implicit-GEMM) convolution on the CUDA cores in f32.
// A block owns a 16 x 64 tile of output pixels and CO_T output channels;
// each thread computes 4 neighbouring pixels of one row x CO_T channels in
// registers. The input tile plus its (KH - 1, KW - 1) halo is staged in
// shared memory as f32 a chunk of up to 8 input channels at a time,
// together with that chunk's weights ([dy][dx][ci][co]); the TPU kernel's
// double-buffered row DMA becomes this staging, its row-im2col for
// cin < 128 becomes the register window: for each (dy, ci) a thread loads
// the 4 + KW - 1 input values of its row once and reuses them across the
// KW taps, so a shared-memory load feeds about 4 * CO_T * KW / (KW + 3)
// FMAs (the stem's 4 input channels and the final conv's 3 output channels
// need no lane padding to 128). The final conv runs on its real 3 output
// channels (one of the 4 register lanes idle) rather than on the s=4
// phase-packed weights the JAX route feeds its kernel: with no matrix unit
// to fill, packing would only add its 2.9x operations. bf16 inputs are
// widened to f32 on staging, so the sums match an f32 conv of the same
// bf16 values. Tensor-core MMA for bf16 inputs and a cp.async/TMA ring
// are the levers for a later version.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mit::bf16;

constexpr int TY = 16, TX = 16, PX = 4;          // 256 threads, 16 x 64 px
constexpr int TH = TY, TW = TX * PX;
constexpr int THREADS = TY * TX;
constexpr int CK = 8;                            // input channels per stage

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TI, typename TO, int CO_T, int KW>
__global__ void __launch_bounds__(THREADS)
conv_stream(const TI* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, TO* __restrict__ out, int hp,
            int wp, int cin, int kh, int cout, int relu, int co_groups) {
  extern __shared__ __align__(16) float smem[];
  constexpr int COLS = TW + KW - 1;
  const int rows = TH + kh - 1;
  const int ho = hp - kh + 1, wo = wp - KW + 1;
  float* xs = smem;                                   // [CK][rows][COLS]
  float* ws = smem + ((CK * rows * COLS + 3) & ~3);   // [kh][KW][CK][CO_T]

  const int n = blockIdx.z / co_groups;
  const int co0 = (blockIdx.z % co_groups) * CO_T;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const TI* xn = x + (long long)n * hp * wp * cin;

  float acc[PX][CO_T];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < CO_T; ++o) acc[p][o] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    const int ck = min(CK, cin - c0);
    __syncthreads();
    // input tile + halo, channel fastest in the loop (coalesced reads)
    const int npix = rows * COLS;
    for (int i = tid; i < npix * ck; i += THREADS) {
      const int ci = i % ck, pix = i / ck;
      const int r = pix / COLS, col = pix - r * COLS;
      const int gy = y0 + r, gx = x0 + col;
      float v = 0.f;
      if (gy < hp && gx < wp)
        v = load_f(xn + ((long long)gy * wp + gx) * cin + c0 + ci);
      xs[(ci * rows + r) * COLS + col] = v;
    }
    // this chunk's weights, zero past cout
    const int nw = kh * KW * ck * CO_T;
    for (int i = tid; i < nw; i += THREADS) {
      const int o = i % CO_T, rest = i / CO_T;
      const int ci = rest % ck, tap = rest / ck;
      const int go = co0 + o;
      ws[i] = go < cout ? w[((long long)tap * cin + c0 + ci) * cout + go]
                        : 0.f;
    }
    __syncthreads();
    for (int dy = 0; dy < kh; ++dy) {
      for (int ci = 0; ci < ck; ++ci) {
        const float* src = xs + (ci * rows + ty + dy) * COLS + tx * PX;
        float win[PX + KW - 1];
#pragma unroll
        for (int j = 0; j < PX + KW - 1; ++j) win[j] = src[j];
        const float* wrow = ws + ((dy * KW) * ck + ci) * CO_T;
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          const float* wt = wrow + dx * ck * CO_T;
#pragma unroll
          for (int o = 0; o < CO_T; o += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wt + o);
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              const float v = win[p + dx];
              acc[p][o] = fmaf(v, w4.x, acc[p][o]);
              acc[p][o + 1] = fmaf(v, w4.y, acc[p][o + 1]);
              acc[p][o + 2] = fmaf(v, w4.z, acc[p][o + 2]);
              acc[p][o + 3] = fmaf(v, w4.w, acc[p][o + 3]);
            }
          }
        }
      }
    }
  }

  const int oy = y0 + ty;
  if (oy >= ho) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = x0 + tx * PX + p;
    if (ox >= wo) continue;
    TO* dst = out + (((long long)n * ho + oy) * wo + ox) * cout;
#pragma unroll
    for (int o = 0; o < CO_T; ++o) {
      const int go = co0 + o;
      if (go >= cout) continue;
      float v = acc[p][o];
      if (bias != nullptr) v += bias[go];
      if (relu) v = fmaxf(v, 0.f);
      store_f(dst + go, v);
    }
  }
}

template <int KW>
constexpr size_t smem_bytes(int kh, int co_t) {
  return (size_t)(((CK * (TH + kh - 1) * (TW + KW - 1) + 3) & ~3) +
                  kh * KW * CK * co_t) * sizeof(float);
}

template <typename TI, typename TO, int CO_T, int KW>
cudaError_t launch(const void* x, const float* w, const float* bias,
                   void* out, int n, int hp, int wp, int cin, int kh,
                   int cout, int relu, cudaStream_t stream) {
  const int ho = hp - kh + 1, wo = wp - KW + 1;
  const int groups = (cout + CO_T - 1) / CO_T;
  const size_t bytes = smem_bytes<KW>(kh, CO_T);
  auto kernel = conv_stream<TI, TO, CO_T, KW>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((wo + TW - 1) / TW, (ho + TH - 1) / TH, n * groups);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const TI*>(x), w, bias, static_cast<TO*>(out), hp, wp, cin,
      kh, cout, relu, groups);
  return cudaGetLastError();
}

template <typename TI, typename TO, int KW>
cudaError_t by_cout(const void* x, const float* w, const float* bias,
                    void* out, int n, int hp, int wp, int cin, int kh,
                    int cout, int relu, cudaStream_t stream) {
  if (cout >= 16)
    return launch<TI, TO, 16, KW>(x, w, bias, out, n, hp, wp, cin, kh, cout,
                                  relu, stream);
  return launch<TI, TO, 4, KW>(x, w, bias, out, n, hp, wp, cin, kh, cout,
                               relu, stream);
}

template <typename TI, typename TO>
cudaError_t by_kw(const void* x, const float* w, const float* bias,
                  void* out, int n, int hp, int wp, int cin, int kh, int kw,
                  int cout, int relu, cudaStream_t stream) {
  switch (kw) {
    case 1: return by_cout<TI, TO, 1>(x, w, bias, out, n, hp, wp, cin, kh,
                                      cout, relu, stream);
    case 3: return by_cout<TI, TO, 3>(x, w, bias, out, n, hp, wp, cin, kh,
                                      cout, relu, stream);
    case 5: return by_cout<TI, TO, 5>(x, w, bias, out, n, hp, wp, cin, kh,
                                      cout, relu, stream);
    case 7: return by_cout<TI, TO, 7>(x, w, bias, out, n, hp, wp, cin, kh,
                                      cout, relu, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. (in, out) pairs served:
// (f32, f32), (bf16, bf16), (bf16, f32).
extern "C" int mit_conv_stream(const void* x, const float* w,
                               const float* bias, void* out, int n, int hp,
                               int wp, int cin, int kh, int kw, int cout,
                               int relu, int in_bf16, int out_bf16,
                               cudaStream_t stream) {
  if (kh < 1 || kh > 7 || hp < kh || wp < kw || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  if (!in_bf16 && !out_bf16)
    return (int)by_kw<float, float>(x, w, bias, out, n, hp, wp, cin, kh, kw,
                                    cout, relu, stream);
  if (in_bf16 && out_bf16)
    return (int)by_kw<bf16, bf16>(x, w, bias, out, n, hp, wp, cin, kh, kw,
                                  cout, relu, stream);
  if (in_bf16)
    return (int)by_kw<bf16, float>(x, w, bias, out, n, hp, wp, cin, kh, kw,
                                   cout, relu, stream);
  return (int)cudaErrorInvalidValue;
}
