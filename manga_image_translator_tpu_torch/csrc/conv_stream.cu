// K5: streaming stride-1 VALID NHWC convolution for Hopper (sm_90a).
//
// Replaces: manga_image_translator_tpu/ops/pallas_conv.py, conv2d_stream
//   (_conv_call, body _conv_kernel).
//
// Computes out[n, y, x, o] = act(bias[o] + sum_{dy, dx, i}
//   x[n, y + dy, x + dx, i] * w[dy, dx, i, o]) over an input the caller has
// already padded, HWIO weights, f32 accumulation, with bias, ReLU and the
// cast to the output dtype fused into the epilogue. On the LaMa path it
// runs the stem (reflect-padded 7x7, 4 -> 64, ReLU, bf16 out) and the
// final conv (reflect-padded 7x7, 64 -> 3, f32 out).
//
// What bounds it on the H100: bytes. At a 1024^2 crop in bf16 the stem
// moves 143 MB (almost all of it the 64-channel output) against 26 GFLOP,
// the final conv 148 MB against 20 GFLOP: ~43 us of bytes each, above
// their bf16 tensor-core time.
//
// Routes, by input dtype:
// * bf16 input with cin in {4, 8} or a multiple of 16, cout <= 64 and
//   KH, KW <= 7 (the LaMa stem and final conv): conv_stream_tc, an
//   implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 x bf16 ->
//   f32). M is a tile of output pixels, N the output channels (64 for the
//   stem; 3 padded to 8 for the final conv, pad lanes never stored), K
//   follows the TPU kernel's order: per dy the KW taps x CK channels of
//   one input row, so an A row is read straight from the haloed tile at
//   pixel x + k / CK, channel k % CK. The stem (CK = cin = 4) is the TPU's
//   row-im2col: 7 taps x 4 channels = 28 values, padded to 32 (two k16
//   steps; the pad's A values are zeroed in registers). The final conv
//   (cin 64) is one K = 64 product per tap, split into 4 channel chunks
//   of 16, each chunk's 49 taps one k16 step each. Weights are bf16 in
//   the layout [chunk][dy][n][k], packed from the f32 HWIO weights by this
//   file's own pack kernel (mit_conv_stream_tc_pack; the caller keeps the
//   result per weight set, so the layout and the tile geometry live here
//   only) and copied into shared memory once per block with cp.async.
//   Blocks are persistent (as many as fit on the card), each
//   walks its (tile, chunk) stages through a 3-deep cp.async ring: the
//   next stages' haloed input rows load while this one computes (the TPU
//   kernel's double-buffered row DMA). A warp owns one output row of the
//   8-row tile: 32 pixels x 64 channels (stem) or 64 pixels x 8 (final).
//   The epilogue adds the bias, applies ReLU and casts into a warp-private
//   shared-memory tile, then the warp stores its row's contiguous run of
//   NHWC output with 16-byte (or full-line 4-byte) coalesced stores.
// * f32 input: conv_stream, a direct convolution on the CUDA cores in f32
//   (off the main path: the f32 generator checks). A block owns a
//   16 x 64 tile of output pixels and
//   CO_T output channels; each thread computes 4 neighbouring pixels of
//   one row x CO_T channels in registers. The input tile plus its halo is
//   staged in shared memory as f32 a chunk of up to 8 input channels at a
//   time, with that chunk's weights; for each (dy, ci) a thread loads the
//   4 + KW - 1 input values of its row once and reuses them across the KW
//   taps.
// A bf16 shape outside the tensor-core route is refused: the entry points
// return cudaErrorInvalidValue before they launch anything.
//
// Times (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): stem + final of
// one bf16 forward at (6, 256, 640) take 0.594 ms on the tensor cores
// (stem 0.160, final 0.434; cuDNN's bf16 conv 1.772, bound 0.0823); the
// CUDA-core body took 2.408 ms for them (timed one call per event pair).
// The final conv is 10x its bound: at N = 8 each 512-byte A fragment read
// from shared memory feeds one mma; packing its 7 taps x 3 channels into
// N = 24 would read a fragment once for 3 (not tried).
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using mit::bf16;

constexpr int TY = 16, TX = 16, PX = 4;          // 256 threads, 16 x 64 px
constexpr int TH = TY, TW = TX * PX;
constexpr int THREADS = TY * TX;
constexpr int CK = 8;                            // input channels per stage

template <int CO_T, int KW>
__global__ void __launch_bounds__(THREADS)
conv_stream(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int hp,
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
  const float* xn = x + (long long)n * hp * wp * cin;

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
        v = xn[((long long)gy * wp + gx) * cin + c0 + ci];
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
    float* dst = out + (((long long)n * ho + oy) * wo + ox) * cout;
#pragma unroll
    for (int o = 0; o < CO_T; ++o) {
      const int go = co0 + o;
      if (go >= cout) continue;
      float v = acc[p][o];
      if (bias != nullptr) v += bias[go];
      if (relu) v = fmaxf(v, 0.f);
      dst[go] = v;
    }
  }
}

template <int KW>
constexpr size_t smem_bytes(int kh, int co_t) {
  return (size_t)(((CK * (TH + kh - 1) * (TW + KW - 1) + 3) & ~3) +
                  kh * KW * CK * co_t) * sizeof(float);
}

template <int CO_T, int KW>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int n, int hp, int wp, int cin, int kh,
                   int cout, int relu, cudaStream_t stream) {
  const int ho = hp - kh + 1, wo = wp - KW + 1;
  const int groups = (cout + CO_T - 1) / CO_T;
  const size_t bytes = smem_bytes<KW>(kh, CO_T);
  auto kernel = conv_stream<CO_T, KW>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((wo + TW - 1) / TW, (ho + TH - 1) / TH, n * groups);
  kernel<<<grid, THREADS, bytes, stream>>>(x, w, bias, out, hp, wp, cin, kh,
                                           cout, relu, groups);
  return cudaGetLastError();
}

template <int KW>
cudaError_t by_cout(const float* x, const float* w, const float* bias,
                    float* out, int n, int hp, int wp, int cin, int kh,
                    int cout, int relu, cudaStream_t stream) {
  if (cout >= 16)
    return launch<16, KW>(x, w, bias, out, n, hp, wp, cin, kh, cout, relu,
                          stream);
  return launch<4, KW>(x, w, bias, out, n, hp, wp, cin, kh, cout, relu,
                       stream);
}

// ---------------------------------------------------------------------------
// tensor-core route (bf16 input)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int WARPS = 8;               // one output row of the tile each
constexpr int THREADS = WARPS * 32;
constexpr int TH = WARPS;              // output rows per tile
constexpr int STAGES = 3;              // depth of the cp.async ring
constexpr int SMEM_LIMIT = 232448;     // a block's shared memory on sm_90

// channels of a pixel in a ring stage: CK, padded to 24 for CK = 16 so the
// 8 rows of an A fragment fall in distinct banks
__host__ __device__ constexpr int pixel_stride(int ck) {
  return ck == 16 ? 24 : ck;
}
__host__ __device__ constexpr int k_steps(int kw, int ck) {
  return (kw * ck + 15) / 16;
}
// a packed weight row (one output channel of one (chunk, dy)): the k16
// steps plus 8 so the 8 rows of a B fragment fall in distinct banks
__host__ __device__ constexpr int k_stride(int kw, int ck) {
  return k_steps(kw, ck) * 16 + 8;
}

template <int NT>
struct Tile {
  static constexpr int MT = NT == 1 ? 4 : 2;   // m16 tiles per warp
  static constexpr int TW = 16 * MT;           // output columns per tile
};

// output-staging row stride (elements): 16-byte rows, spread over banks
template <typename TO, int NT>
__host__ __device__ constexpr int stage_row() {
  return NT * 8 + (sizeof(TO) == 2 ? 8 : 4);
}

struct Layout {
  int stage_elems, w_elems, stg_elems;
  size_t bytes;
};

template <typename TO, int CK, int NT>
__host__ __device__ Layout layout(int cin, int kh, int kw) {
  constexpr int TW = Tile<NT>::TW;
  Layout l;
  l.stage_elems =
      (((TH + kh - 1) * (TW + kw - 1) * pixel_stride(CK)) + 7) & ~7;
  l.w_elems = (cin / CK) * kh * NT * 8 * k_stride(kw, CK);
  l.stg_elems = WARPS * TW * stage_row<TO, NT>();
  l.bytes = (size_t)(STAGES * l.stage_elems + l.w_elems) * sizeof(bf16) +
            (size_t)l.stg_elems * sizeof(TO);
  return l;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// a route's shape: cin in {4, 8} or a multiple of 16, cout <= 64, KH and
// KW <= 7
bool served(int cin, int kh, int kw, int cout) {
  return kh >= 1 && kh <= 7 && kw >= 1 && kw <= 7 && cout >= 1 &&
         cout <= 64 && (cin == 4 || cin == 8 || (cin > 0 && cin % 16 == 0));
}
int chunk_of(int cin) { return cin == 4 || cin == 8 ? cin : 16; }
int n_tiles_of(int cout) { return cout <= 8 ? 1 : 8; }

// wpk[chunk][dy][n][k] = bf16(w[dy][dx][chunk * CK + i][n]) at k = dx * CK
// + i, zero past KW * CK (the k16 pad and the row's bank pad) and past cout
template <int CK, int NT>
__global__ void pack_weights(const float* __restrict__ w,
                             bf16* __restrict__ wpk, int cin, int kh, int kw,
                             int cout) {
  const int kstr = k_stride(kw, CK);
  const int total = (cin / CK) * kh * NT * 8 * kstr;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int k = i % kstr, row = i / kstr;
    const int o = row % (NT * 8), cdy = row / (NT * 8);
    const int dy = cdy % kh, chunk = cdy / kh;
    const int dx = k / CK, ci = k % CK;
    const float v =
        dx < kw && o < cout
            ? w[(((long long)dy * kw + dx) * cin + chunk * CK + ci) * cout + o]
            : 0.f;
    wpk[i] = __float2bfloat16_rn(v);
  }
}

template <int CK>
cudaError_t pack_by_nt(const float* w, bf16* wpk, int cin, int kh, int kw,
                       int cout, cudaStream_t stream) {
  if (n_tiles_of(cout) == 1)
    pack_weights<CK, 1><<<64, THREADS, 0, stream>>>(w, wpk, cin, kh, kw, cout);
  else
    pack_weights<CK, 8><<<64, THREADS, 0, stream>>>(w, wpk, cin, kh, kw, cout);
  return cudaGetLastError();
}

template <typename TO, int CK, int NT>
__global__ void __launch_bounds__(THREADS)
conv_stream_tc(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
               const float* __restrict__ bias, TO* __restrict__ out, int n,
               int hp, int wp, int cin, int kh, int kw, int cout, int relu) {
  constexpr int MT = Tile<NT>::MT, TW = Tile<NT>::TW;
  constexpr int PS = pixel_stride(CK);
  constexpr int RS = stage_row<TO, NT>();
  constexpr int PIECES = CK * 2 >= 16 ? CK * 2 / 16 : 1;  // copies / pixel
  constexpr int PB = CK * 2 / PIECES;                      // bytes / copy
  constexpr int KS_MAX = k_steps(7, CK);                   // KW <= 7
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const Layout l = layout<TO, CK, NT>(cin, kh, kw);
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);
  bf16* ws = ring + STAGES * l.stage_elems;
  TO* stg = reinterpret_cast<TO*>(ws + l.w_elems);

  const int ho = hp - kh + 1, wo = wp - kw + 1;
  const int rows = TH + kh - 1, cols = TW + kw - 1;
  const int ksn = k_steps(kw, CK), kstr = k_stride(kw, CK);
  const int kvalid = kw * CK;
  const int nc = cin / CK;
  const int tiles_x = (wo + TW - 1) / TW, tiles_y = (ho + TH - 1) / TH;
  const int tiles = n * tiles_y * tiles_x;
  if ((int)blockIdx.x >= tiles) return;
  const int n_stages =
      (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  TO* my_stg = stg + warp * TW * RS;

  // the packed weights, once per block (in the first copy group)
  for (int i = tid; i < l.w_elems / 8; i += THREADS)
    mit::cp_async<16>(ws + i * 8, wpk + i * 8, 16);

  auto tile_origin = [&](int s, int& img, int& y0, int& x0) {
    const int tile = (int)blockIdx.x + (s / nc) * (int)gridDim.x;
    img = tile / (tiles_y * tiles_x);
    const int rem = tile - img * tiles_y * tiles_x;
    y0 = (rem / tiles_x) * TH;
    x0 = (rem % tiles_x) * TW;
  };
  // stage s: the haloed input tile of its tile, channels of its chunk
  constexpr int STEP = THREADS / PIECES;
  const int part = tid % PIECES, pix0 = tid / PIECES;
  const int step_r = STEP / cols, step_c = STEP - step_r * cols;
  auto issue = [&](int s) {
    int img, y0, x0;
    tile_origin(s, img, y0, x0);
    const int c0 = (s % nc) * CK;
    bf16* dst = ring + (s % STAGES) * l.stage_elems;
    const bf16* src0 = x + (long long)img * hp * wp * cin + c0;
    // this thread copies one part of every (THREADS / PIECES)-th pixel,
    // walking (r, c) without a division per copy
    int r = pix0 / cols, c = pix0 - (pix0 / cols) * cols;
    for (int pix = pix0; pix < rows * cols; pix += STEP) {
      const int gy = y0 + r, gx = x0 + c;
      const bool in = gy < hp && gx < wp;
      const bf16* src =
          in ? src0 + ((long long)gy * wp + gx) * cin + part * (PB / 2) : x;
      mit::cp_async<PB>(dst + pix * PS + part * (PB / 2), src, in ? PB : 0);
      r += step_r;
      c += step_c;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
  };

  float bias_r[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = nt * 8 + t * 2 + j;
      bias_r[nt][j] = (bias != nullptr && col < cout) ? bias[col] : 0.f;
    }
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) issue(s);
    mit::cp_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    if (s + STAGES - 1 < n_stages) issue(s + STAGES - 1);
    mit::cp_commit();
    mit::cp_wait<STAGES - 1>();
    __syncthreads();
    const int chunk = s % nc;
    const bf16* tile_s = ring + (s % STAGES) * l.stage_elems;
    const bf16* wc = ws + chunk * kh * NT * 8 * kstr;
    for (int dy = 0; dy < kh; ++dy) {
      // this warp's output row at dy, its lane's pixel column g
      const bf16* arow = tile_s + ((warp + dy) * cols + g) * PS;
      const bf16* wrow = wc + (dy * NT * 8 + g) * kstr + t * 2;
      const bf16* arow0 = tile_s + (warp + dy) * cols * PS;
#pragma unroll
      for (int ks = 0; ks < KS_MAX; ++ks) {
        if (ks >= ksn) break;
        // the lane's two k pairs: pixel shift k / CK, channel k % CK
        const int k0 = ks * 16 + t * 2, k1 = k0 + 8;
        const bool v0 = k0 < kvalid, v1 = k1 < kvalid;
        uint32_t b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          b[nt][0] = ld32(wrow + nt * 8 * kstr + ks * 16);
          b[nt][1] = ld32(wrow + nt * 8 * kstr + ks * 16 + 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          if constexpr (CK >= 8) {
            // 8 consecutive k of one pixel are 16 aligned bytes: one
            // ldmatrix per fragment (lanes 0-15 rows at k, 16-31 at k + 8)
            int k = ks * 16 + (lane >> 4) * 8;
            if (k >= kvalid) k = 0;            // zeroed below
            mit::ldmatrix_x4(a, arow0 + (mt * 16 + (lane & 15) + k / CK) * PS +
                                    k % CK);
            if (!v1) a[2] = a[3] = 0u;
          } else {
            const int o0 = (k0 / CK) * PS + k0 % CK;
            const int o1 = (k1 / CK) * PS + k1 % CK;
            const bf16* p = arow + mt * 16 * PS;
            a[0] = v0 ? ld32(p + o0) : 0u;
            a[1] = v0 ? ld32(p + 8 * PS + o0) : 0u;
            a[2] = v1 ? ld32(p + o1) : 0u;
            a[3] = v1 ? ld32(p + 8 * PS + o1) : 0u;
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mit::mma_bf16(acc[mt][nt], a, b[nt]);
        }
      }
    }
    if (chunk == nc - 1) {
      // epilogue: bias, ReLU, cast into the warp's staging rows, then the
      // warp stores its output row's contiguous NHWC run
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* c = acc[mt][nt];
          float v[4] = {c[0] + bias_r[nt][0], c[1] + bias_r[nt][1],
                        c[2] + bias_r[nt][0], c[3] + bias_r[nt][1]};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (relu) v[j] = fmaxf(v[j], 0.f);
            c[j] = 0.f;
          }
          TO* row = my_stg + (mt * 16 + g) * RS + nt * 8 + t * 2;
          mit::store2(row, v[0], v[1]);
          mit::store2(row + 8 * RS, v[2], v[3]);
        }
      __syncwarp();
      int img, y0, x0;
      tile_origin(s, img, y0, x0);
      const int oy = y0 + warp;
      if (oy < ho) {
        const int npx = min(TW, wo - x0);
        TO* dst = out + (((long long)img * ho + oy) * wo + x0) * cout;
        constexpr int ELEM = sizeof(TO);
        if ((cout * ELEM) % 16 == 0) {
          const int q = cout * ELEM / 16;
          for (int i = lane; i < npx * q; i += 32) {
            const int p = i / q, j = i - p * q;
            *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst) +
                                      ((size_t)p * q + j) * 16) =
                *reinterpret_cast<const uint4*>(
                    reinterpret_cast<const char*>(my_stg + p * RS) + j * 16);
          }
        } else {
          for (int i = lane; i < npx * cout; i += 32) {
            const int p = i / cout;
            dst[i] = my_stg[p * RS + i - p * cout];
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename TO, int CK, int NT>
cudaError_t launch(const bf16* x, const bf16* wpk, const float* bias,
                   TO* out, int n, int hp, int wp, int cin, int kh, int kw,
                   int cout, int relu, cudaStream_t stream) {
  const Layout l = layout<TO, CK, NT>(cin, kh, kw);
  if (l.bytes > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = conv_stream_tc<TO, CK, NT>;
  // the shared-memory size and the blocks per SM it allows, queried once
  // per instantiation and size
  static size_t sized = 0;
  static int per_sm = 1;
  if (sized != l.bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, l.bytes);
    if (e != cudaSuccess) return e;
    sized = l.bytes;
  }
  constexpr int TW = Tile<NT>::TW;
  const int ho = hp - kh + 1, wo = wp - kw + 1;
  const long long tiles =
      (long long)n * ((ho + TH - 1) / TH) * ((wo + TW - 1) / TW);
  const int grid = (int)std::min<long long>(tiles,
                                            (long long)sm_count() *
                                                std::max(per_sm, 1));
  kernel<<<grid, THREADS, l.bytes, stream>>>(x, wpk, bias, out, n, hp, wp,
                                             cin, kh, kw, cout, relu);
  return cudaGetLastError();
}

template <typename TO, int CK>
cudaError_t by_nt(const bf16* x, const bf16* wpk, const float* bias, TO* out,
                  int n, int hp, int wp, int cin, int kh, int kw, int cout,
                  int relu, cudaStream_t stream) {
  if (n_tiles_of(cout) == 1)
    return launch<TO, CK, 1>(x, wpk, bias, out, n, hp, wp, cin, kh, kw, cout,
                             relu, stream);
  return launch<TO, CK, 8>(x, wpk, bias, out, n, hp, wp, cin, kh, kw, cout,
                           relu, stream);
}

template <typename TO>
cudaError_t by_ck(const bf16* x, const bf16* wpk, const float* bias, TO* out,
                  int n, int hp, int wp, int cin, int kh, int kw, int cout,
                  int relu, cudaStream_t stream) {
  switch (chunk_of(cin)) {
    case 4: return by_nt<TO, 4>(x, wpk, bias, out, n, hp, wp, cin, kh, kw,
                                cout, relu, stream);
    case 8: return by_nt<TO, 8>(x, wpk, bias, out, n, hp, wp, cin, kh, kw,
                                cout, relu, stream);
    default: return by_nt<TO, 16>(x, wpk, bias, out, n, hp, wp, cin, kh, kw,
                                  cout, relu, stream);
  }
}

}  // namespace tc

}  // namespace

// The CUDA-core route: f32 input and output.
extern "C" int mit_conv_stream(const float* x, const float* w,
                               const float* bias, float* out, int n, int hp,
                               int wp, int cin, int kh, int kw, int cout,
                               int relu, cudaStream_t stream) {
  if (kh < 1 || kh > 7 || hp < kh || wp < kw || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  switch (kw) {
    case 1: return (int)by_cout<1>(x, w, bias, out, n, hp, wp, cin, kh, cout,
                                   relu, stream);
    case 3: return (int)by_cout<3>(x, w, bias, out, n, hp, wp, cin, kh, cout,
                                   relu, stream);
    case 5: return (int)by_cout<5>(x, w, bias, out, n, hp, wp, cin, kh, cout,
                                   relu, stream);
    case 7: return (int)by_cout<7>(x, w, bias, out, n, hp, wp, cin, kh, cout,
                                   relu, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core route's packed weights: how many bf16 elements they
// take, or -1 for a shape the route does not serve.
extern "C" int mit_conv_stream_tc_packed_elems(int cin, int kh, int kw,
                                               int cout) {
  if (!tc::served(cin, kh, kw, cout)) return -1;
  const int ck = tc::chunk_of(cin);
  return cin / ck * kh * tc::n_tiles_of(cout) * 8 * tc::k_stride(kw, ck);
}

// Packs f32 HWIO weights into wpk (mit_conv_stream_tc_packed_elems bf16
// elements) for mit_conv_stream_tc.
extern "C" int mit_conv_stream_tc_pack(const float* w, void* wpk, int cin,
                                       int kh, int kw, int cout,
                                       cudaStream_t stream) {
  if (!tc::served(cin, kh, kw, cout)) return (int)cudaErrorInvalidValue;
  bf16* out = static_cast<bf16*>(wpk);
  switch (tc::chunk_of(cin)) {
    case 4: return (int)tc::pack_by_nt<4>(w, out, cin, kh, kw, cout, stream);
    case 8: return (int)tc::pack_by_nt<8>(w, out, cin, kh, kw, cout, stream);
    default:
      return (int)tc::pack_by_nt<16>(w, out, cin, kh, kw, cout, stream);
  }
}

// The tensor-core route: bf16 input, weights from mit_conv_stream_tc_pack;
// a shape it serves whose tile plan fits in shared memory, else
// cudaErrorInvalidValue. out_bf16: 1 = bf16 output, 0 = f32.
extern "C" int mit_conv_stream_tc(const void* x, const void* wpk,
                                  const float* bias, void* out, int n, int hp,
                                  int wp, int cin, int kh, int kw, int cout,
                                  int relu, int out_bf16,
                                  cudaStream_t stream) {
  if (!tc::served(cin, kh, kw, cout) || hp < kh || wp < kw)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(wpk);
  if (out_bf16)
    return (int)tc::by_ck<bf16>(xb, wb, bias, static_cast<bf16*>(out), n, hp,
                                wp, cin, kh, kw, cout, relu, stream);
  return (int)tc::by_ck<float>(xb, wb, bias, static_cast<float*>(out), n, hp,
                               wp, cin, kh, kw, cout, relu, stream);
}
