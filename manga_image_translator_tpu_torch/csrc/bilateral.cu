// K1: bilateral filter (cv2.bilateralFilter semantics) for Hopper (sm_90a).
//
// Replaces: manga_image_translator_tpu/ops/pallas_bilateral.py,
//   bilateral_filter_pallas (default body _kernel_paired, v6).
//
// What bounds it on the H100: operations, not bytes. A 2048x2048x3 uint8
// page moves 25 MB (read + write), ~7.5 us at 3.35 TB/s, while every pixel
// accumulates 196 window taps (d=17: 98 symmetric offset pairs around the
// centre), 3 FMAs and 1 add each, and needs one colour weight per pair:
// ~1,970 operations per pixel (an FMA counting 2), ~123 us at the 67
// TFLOP/s f32 CUDA-core rate. In instructions a tap costs at least its 4
// accumulating ones plus its weight's, and the issue rate (one warp
// instruction per clock per SM sub-partition) is what bounds this kernel:
// the unrolled r = 8 instance issues ~1,710 instructions a pixel (static
// SASS, ops/bilateral_sweep.py), 0.214 ms at 2048^2 at 1.98 GHz, with the
// special-function unit (16 exp2 per clock per SM) and the shared-memory
// pipe each about half busy.
//
// Design. One block of 32x8 threads per 32x64 output tile; each thread owns
// a vertical strip of S=8 outputs in one column.
// * The tile plus its radius-r halo is staged once in shared memory, edge-
//   clamped while loading, one float4 per pixel: the three channels as f32
//   and, in the fourth word, the pixel packed as bytes (b0 | b1<<8 | b2<<16).
// * The thread walks the window one column at a time, top to bottom: each
//   source pixel is one 16-byte shared load that serves every output of the
//   strip within the circle's half-height of that column (~40 loads a
//   pixel instead of 784 word loads).
// * Colour distance: one vabsdiff4 of the packed words gives the integer
//   L1 distance d (0..765), with no float-to-int conversion. Even outputs
//   of the strip take the colour weight from the special-function unit:
//   d*d + 0x4B000000 read as a float is 2^23 + d^2 exactly, fma(x, g,
//   -2^23 g) is fl(g d^2) with g = log2(e) * gc, and ex2.approx of that is
//   the weight, times the space weight. With sigma_color == sigma_space
//   (the main path's 80, 80) both weights are one exp2(g (d^2 + rho)), rho
//   = dy^2 + dx^2: the IMAD adds 0x4B000000 + rho and the multiply goes
//   (vabsdiff4, IMAD, FFMA, MUFU.EX2). Odd outputs read exp2(fl(g d^2))
//   from a 766-entry table in shared memory, built by each block with the
//   same expression, times the space weight (vabsdiff4, LEA, LDS, FMUL).
//   Either unit alone saturates first (the SFU at 16 a clock per SM; the
//   table's bank conflicts on random bytes); interleaved they share the
//   work, and random bytes cost ~1% more than a page.
// * Within a strip, the pairs of the centre column (dx = 0) share one
//   weight: pair (i, k), i < k, is met once, when source row k is walked,
//   and feeds output i's +o tap and output k's -o tap; the weight of an
//   integer distance is symmetric to the bit. Other pairs span two
//   threads' columns, and passing a weight through a shuffle or shared
//   memory costs the same pipe time as the exp2 it saves (and a full warp
//   instruction for the lanes at the warp's edge), so each tap computes its
//   own weight there.
// * The radius is a template parameter: r = 8 (d = 17, the only radius the
//   main path uses) is unrolled over all 17 columns, each with its dx and
//   half-height fixed; a generic instance serves 1 <= r <= 16 with runtime
//   loops, and every radius when the sigmas differ. The host picks the
//   instance by r and the sigmas.
// * Space weights travel with the launch: one f32 per squared distance
//   dy^2 + dx^2 (0..r^2) in a kernel parameter, staged in shared memory by
//   each block; no per-call host-to-device copy and no global state.
// * Sums are f32 in a fixed order (per output: centre, then the columns
//   left to right, each top to bottom; shared pairs when their lower row
//   is walked), then times the norm's reciprocal, round-half-even and clip
//   to uint8. The batch is gridDim.z.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_R = 16;
constexpr int TW = 32;           // output columns per block, one per lane
constexpr int NY = 8;            // warps per block, stacked vertically
constexpr int S = 8;             // output rows per thread (its strip)
constexpr int TH = NY * S;       // output rows per block
constexpr int THREADS = TW * NY;
constexpr int CD_MAX = 3 * 255;  // the largest L1 colour distance
// every SFU_EVERY-th output of a strip (i % SFU_EVERY == 0) takes its colour
// weights from the special-function unit, the others from the table
constexpr int SFU_EVERY = 2;

struct SpaceW {
  float w[MAX_R * MAX_R + 1];    // space weight by dy^2 + dx^2
};

// each block's copies of the space weights by rho and of the colour weights
// by d
__shared__ float s_space[MAX_R * MAX_R + 1];
__shared__ float s_range[CD_MAX + 1];

struct Acc {
  float a0, a1, a2, n;
};

// sum over the bytes of |a - b|, plus c
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The colour weight exp(gc d^2) of the integer L1 distance d: ex2.approx of
// fma(2^23 + d^2, g, -2^23 g) = fl(g d^2), g = log2(e) * gc, ng23 = -2^23 g.
__device__ __forceinline__ float colour_weight(uint32_t d, float g,
                                               float ng23) {
  return ex2(fmaf(__uint_as_float(d * d + 0x4B000000u), g, ng23));
}

// The weight of two packed pixels at squared offset rho = dy^2 + dx^2.
// table: the colour weight read from the block's table by d, times the
// space weight sp (vabsdiff4, LEA, LDS, FMUL). Else on the
// special-function unit: sp * colour_weight(d), or, with fold (sigma_color
// == sigma_space, as on the main path), exp(gc d^2) * exp(gs rho) = exp2(g
// (d^2 + rho)) in one: bias = 0x4B000000 + rho, so one IMAD forms 2^23 +
// d^2 + rho exactly and no multiply follows (vabsdiff4, IMAD, FFMA,
// MUFU.EX2). With equal
// sigmas the two routes differ in the last bits; without, they are equal.
__device__ __forceinline__ float weight(bool table, bool fold, uint32_t c,
                                        uint32_t p, float g, float ng23,
                                        uint32_t bias, float sp) {
  const uint32_t d = sad4(c, p, 0u);
  if (table) return sp * s_range[d];
  if (fold) return ex2(fmaf(__uint_as_float(d * d + bias), g, ng23));
  return sp * colour_weight(d, g, ng23);
}

__device__ __forceinline__ void tap(Acc& a, float w, const float4& p) {
  a.a0 = fmaf(w, p.x, a.a0);
  a.a1 = fmaf(w, p.y, a.a1);
  a.a2 = fmaf(w, p.z, a.a2);
  a.n += w;
}

// tap(acc[k], ...) without a runtime index into the register array (which
// would move it to local memory); once unrolled with k fixed it is one tap
__device__ __forceinline__ void tap_at(Acc (&acc)[S], int k, float w,
                                       const float4& p) {
#pragma unroll
  for (int m = 0; m < S; ++m)
    if (m == k) tap(acc[m], w, p);
}

// What a column walk needs besides the accumulators: the strip's first
// source row in this column (r rows above its first output), the tile's
// row pitch, dx^2, g and -2^23 g, and whether the space weight folds into
// the exponent (a constant in the r = 8 instance).
struct Column {
  const float4* col;
  int stride, dx2;
  float g, ng23;
  bool fold;
};

// One window column whose circle half-height is H (HH < 0: runtime h): its
// source rows are walked top to bottom, each loaded once and fed to every
// output of the strip within H rows. CENTRE: dx == 0, where the pairs
// inside the strip share one weight.
template <int RR, int HH, bool CENTRE>
__device__ __forceinline__ void column(Acc (&acc)[S], const uint32_t (&c)[S],
                                       const Column& cl, int r_rt, int h_rt) {
  const int R = RR > 0 ? RR : r_rt;
  const int H = HH >= 0 ? HH : h_rt;
  // the column's space weights and fold biases by |dy| (registers when H
  // is fixed)
  constexpr int NC = HH >= 0 ? HH + 1 : 1;
  float spd[NC];
  uint32_t bd[NC];
  if constexpr (HH >= 0) {
#pragma unroll
    for (int a = 0; a < NC; ++a) {
      spd[a] = s_space[a * a + cl.dx2];
      bd[a] = 0x4B000000u + (uint32_t)(a * a + cl.dx2);
    }
  }
#pragma unroll
  for (int j = R - H; j < R + S + H; ++j) {
    const float4 q = cl.col[j * cl.stride];
    const uint32_t qp = __float_as_uint(q.w);
    const int k = j - R;           // the source row is output k if 0 <= k < S
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int dy = k - i;
      if (dy < -H || dy > H) continue;
      const int ady = dy < 0 ? -dy : dy;
      float sp;
      uint32_t bias;
      if constexpr (HH >= 0) {
        sp = spd[ady];
        bias = bd[ady];
      } else {
        sp = s_space[ady * ady + cl.dx2];
        bias = 0x4B000000u + (uint32_t)(ady * ady + cl.dx2);
      }
      // the special-function unit and the table share the weights,
      // interleaved by output
      const bool table = i % SFU_EVERY != 0;
      if (CENTRE && k >= 0 && k < S) {
        // both pixels in the strip: pair (i, k) is met once, at i < k
        if (i < k) {
          const float w = weight(table, cl.fold, c[i], qp, cl.g, cl.ng23,
                                 bias, sp);
          tap(acc[i], w, q);
          tap_at(acc, k, w, cl.col[(i + R) * cl.stride]);
        }
        continue;
      }
      tap(acc[i],
          weight(table, cl.fold, c[i], qp, cl.g, cl.ng23, bias, sp), q);
    }
  }
}

// every column of the r = RR instance, left to right, each unrolled with
// its dx and half-height fixed at compile time; DX counts up from -RR. The
// instance runs with equal sigmas only: the space weight always folds.
template <int RR, int DX>
__device__ __forceinline__ void columns_unrolled(Acc (&acc)[S],
                                                 const uint32_t (&c)[S],
                                                 const float4* base,
                                                 int stride, float g,
                                                 float ng23) {
  if constexpr (DX <= RR) {
    constexpr int DX2 = DX * DX;
    constexpr int HC = [] {
      int h = 0;
      while ((h + 1) * (h + 1) + DX2 <= RR * RR) ++h;
      return h;
    }();
    const Column cl = {base + RR + DX, stride, DX2, g, ng23, true};
    column<RR, HC, DX == 0>(acc, c, cl, RR, HC);
    columns_unrolled<RR, DX + 1>(acc, c, base, stride, g, ng23);
  }
}

// RR > 0: the radius fixed at compile time, equal sigmas; RR == 0: runtime
// radius r, fold_rt != 0 when the sigmas are equal
template <int RR>
__global__ void __launch_bounds__(THREADS, RR > 0 ? 3 : 2)
bilateral_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 int H, int W, int r_rt, int fold_rt, float g,
                 const SpaceW spw) {
  extern __shared__ float4 tile[];
  const int r = RR > 0 ? RR : r_rt;
  const int stride = TW + 2 * r;
  const int rows = TH + 2 * r;

  const size_t plane = (size_t)H * W * 3;
  const uint8_t* img = src + (size_t)blockIdx.z * plane;
  uint8_t* out = dst + (size_t)blockIdx.z * plane;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;

  const float ng23 = -8388608.0f * g;
  for (int i = tid; i <= r * r; i += THREADS) s_space[i] = spw.w[i];
  for (int d = tid; d <= CD_MAX; d += THREADS)
    s_range[d] = colour_weight(d, g, ng23);
#pragma unroll 4
  for (int i = tid; i < rows * stride; i += THREADS) {
    const int ly = i / stride;
    const int lx = i - ly * stride;
    const int gy = min(max(y0 - r + ly, 0), H - 1);
    const int gx = min(max(x0 - r + lx, 0), W - 1);
    const uint8_t* p = img + ((size_t)gy * W + gx) * 3;
    const uint32_t b0 = p[0], b1 = p[1], b2 = p[2];
    tile[i] = make_float4((float)b0, (float)b1, (float)b2,
                          __uint_as_float(b0 | (b1 << 8) | (b2 << 16)));
  }
  __syncthreads();

  // the strip's first source row in column 0 of the window (dx = -r)
  const float4* base = tile + (threadIdx.y * S) * stride + threadIdx.x;
  Acc acc[S];
  uint32_t c[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    // centre tap: space and colour weights are both exactly 1
    const float4 p = base[(i + r) * stride + r];
    acc[i] = {p.x, p.y, p.z, 1.0f};
    c[i] = __float_as_uint(p.w);
  }
  if constexpr (RR > 0) {
    columns_unrolled<RR, -RR>(acc, c, base, stride, g, ng23);
  } else {
#pragma unroll 1
    for (int dx = -r; dx <= r; ++dx) {
      const Column cl = {base + r + dx, stride, dx * dx, g, ng23,
                         fold_rt != 0};
      int h = 0;      // the circle's half-height in this column
      while ((h + 1) * (h + 1) + cl.dx2 <= r * r) ++h;
      if (dx == 0)
        column<0, -1, true>(acc, c, cl, r, h);
      else
        column<0, -1, false>(acc, c, cl, r, h);
    }
  }

  const int ox = x0 + threadIdx.x;
  if (ox >= W) return;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int oy = y0 + threadIdx.y * S + i;
    if (oy >= H) break;
    // one correctly rounded reciprocal and three products instead of
    // three divisions (each result within an ulp of the quotient)
    const float inv = __frcp_rn(fmaxf(acc[i].n, 1e-8f));
    uint8_t* o = out + ((size_t)oy * W + ox) * 3;
    o[0] = (uint8_t)fminf(fmaxf(rintf(acc[i].a0 * inv), 0.0f), 255.0f);
    o[1] = (uint8_t)fminf(fmaxf(rintf(acc[i].a1 * inv), 0.0f), 255.0f);
    o[2] = (uint8_t)fminf(fmaxf(rintf(acc[i].a2 * inv), 0.0f), 255.0f);
  }
}

template <int RR>
cudaError_t launch(const uint8_t* src, uint8_t* dst, int n, int h, int w,
                   int r, bool fold, float g, const SpaceW& spw,
                   cudaStream_t s) {
  const int smem = (int)sizeof(float4) * (TW + 2 * r) * (TH + 2 * r);
  cudaError_t err = cudaFuncSetAttribute(
      bilateral_kernel<RR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 block(TW, NY);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  bilateral_kernel<RR><<<grid, block, smem, s>>>(src, dst, h, w, r,
                                                 fold ? 1 : 0, g, spw);
  return cudaGetLastError();
}

}  // namespace

// src, dst: (n, h, w, 3) uint8, contiguous, on the device. r = 8 with
// sigma_color == sigma_space (the main path's d = 17, 80, 80) runs the
// instance unrolled for that radius; any other 1 <= r <= 16 or sigmas the
// generic one.
extern "C" int mit_bilateral_u8(const void* src, void* dst, int n, int h,
                                int w, int r, float sigma_color,
                                float sigma_space, void* stream) {
  if (r < 1 || r > MAX_R || n < 1 || h < 1 || w < 1 || n > 65535)
    return (int)cudaErrorInvalidValue;
  SpaceW spw;
  for (int i = 0; i <= MAX_R * MAX_R; ++i)
    spw.w[i] = i <= r * r
                   ? (float)exp(-(double)i / (2.0 * (double)sigma_space *
                                              (double)sigma_space))
                   : 0.0f;
  // log2(e) * gc, gc = -1 / (2 sigma_color^2)
  const float g = (float)(-1.4426950408889634 /
                          (2.0 * (double)sigma_color * (double)sigma_color));
  const uint8_t* s8 = (const uint8_t*)src;
  uint8_t* d8 = (uint8_t*)dst;
  cudaStream_t s = (cudaStream_t)stream;
  const bool fold = sigma_color == sigma_space;
  const cudaError_t err = r == 8 && fold
                              ? launch<8>(s8, d8, n, h, w, r, true, g, spw, s)
                              : launch<0>(s8, d8, n, h, w, r, fold, g, spw, s);
  return (int)err;
}
