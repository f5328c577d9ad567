// K3: fused OCR char head + top-k for Hopper (sm_90a), one launch.
//
// Replaces: manga_image_translator_tpu/ops/pallas_charhead.py,
//   char_topk_fused (body _kernel).
//
// Computes, for every decoder row, the top-k of
//   log_softmax(gelu(dec @ W1 + b1) @ Wv^T + bv)
// without writing the (N, V) logits to device memory.
//
// What bounds it on the H100: bytes. Wv (V x 320 bf16, 5.1 MB at V=7935)
// is read once from device memory (~1.5 us at 3.35 TB/s); the vocab
// product is 2*N*V*320 = 0.61 GFLOP at N=120, under 1 us of bf16
// tensor-core time.
//
// Design: one cooperative launch, one 256-thread block per SM, three
// phases between two grid-wide barriers:
//   1. pred1 + GELU: 40 units of 8 columns of W1 over all N rows (dec rows
//      and the W1 panel staged by cp.async, mma.sync m16n8k16 bf16, exact
//      erf GELU on the accumulators), h written once as bf16 (77 KB).
//   2. vocab: each block owns 64-row slices of Wv (chunk c = block, block +
//      grid, ...), so Wv crosses into the SMs once per call. The block
//      issues its first slice's copies (40 KB) before phase 1, so they land
//      under it and the barrier; after the barrier it stages all N rows of h
//      once (cp.async.cg: h was written by other blocks), multiplies the
//      N x 64 logit tile on the tensor cores (Wv rows are B's columns, read
//      by ldmatrix without a transpose) into shared memory, and groups of 8
//      lanes reduce its rows, 4 per warp at a time, to (chunk max, chunk sum
//      of exp, chunk top-5 with ties to the lower index). The ragged vocab
//      edge is masked.
//   3. merge: one warp per row folds the chunk partials in chunk order into
//      the logsumexp; each lane keeps the top 5 of its candidates sorted in
//      registers (one pass over them), and k rounds of a warp arg-max over
//      the lanes' heads give the final top-k (value desc, index asc); it
//      writes value - lse and the int64 index.
// No atomics on values: a call gives the same bits on every run.
#include <stdint.h>

#include "common.cuh"

namespace {

using mit::bf16;

constexpr int E = 320;
constexpr int TOPC = 5;     // candidates kept per vocab chunk (>= k)
constexpr int CV = 64;      // vocab rows per chunk
constexpr int NMAX = 160;   // decoder rows a launch serves
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int P_CT = 8;     // pred1 columns per unit

constexpr int H_LD = E + 8;
constexpr int W1_LD = 24;
constexpr int L_LD = CV + 8;   // 4 rows' groups of 8 lanes on distinct banks
constexpr size_t H_BYTES = sizeof(bf16) * (size_t)NMAX * H_LD;
constexpr size_t WV_BYTES = sizeof(bf16) * (size_t)CV * H_LD;
constexpr size_t L_BYTES = sizeof(float) * (size_t)NMAX * L_LD;
constexpr int G = 8;       // lanes that reduce one row of a chunk
constexpr size_t SMEM_BYTES = H_BYTES + WV_BYTES + L_BYTES;
static_assert(sizeof(bf16) * E * W1_LD <= L_BYTES,
              "the W1 panel shares the logit tile's space");

struct Params {
  const bf16* dec;     // (n, E)
  const bf16* w1;      // (E, E) [in, out]
  const float* b1;     // (E)
  const bf16* wv;      // (V, E)
  const float* bv;     // (V)
  int n, V, k, n_chunks;
  bf16* h;             // (n, E) scratch
  float *pmax, *psum;  // (n, n_chunks)
  float* pval;         // (n, n_chunks, TOPC)
  int* pidx;
  float* out_val;      // (n, k)
  int64_t* out_idx;
  unsigned* sync;      // grid barrier
};

// the chunk's 64 vocab rows (zero past V)
__device__ void stage_wv(const Params& p, int chunk, bf16* ws) {
  for (int i = threadIdx.x; i < CV * (E / 8); i += THREADS) {
    const int r = i / (E / 8), k8 = (i - r * (E / 8)) * 8;
    const int v = chunk * CV + r;
    mit::cp_async<16>(ws + r * H_LD + k8,
                      v < p.V ? p.wv + (size_t)v * E + k8 : p.wv,
                      v < p.V ? 16 : 0);
  }
}

// n rows of E bf16 into a [row][H_LD] tile
__device__ void stage_rows(const bf16* src, int n, bf16* dst) {
  for (int i = threadIdx.x; i < n * (E / 8); i += THREADS) {
    const int r = i / (E / 8), k8 = (i - r * (E / 8)) * 8;
    mit::cp_async<16>(dst + r * H_LD + k8, src + (size_t)r * E + k8, 16);
  }
}

// phase 1: h[:, 8u..8u+7] = gelu(dec @ W1[:, 8u..8u+7] + b1)
__device__ void pred1_unit(const Params& p, int u, bf16* as, bf16* ps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_rows(p.dec, p.n, as);
  for (int i = threadIdx.x; i < E; i += THREADS)
    mit::cp_async<16>(ps + i * W1_LD, p.w1 + (size_t)i * E + u * P_CT, 16);
  mit::cp_commit();
  mit::cp_wait<0>();
  __syncthreads();
  for (int mt = warp; mt * 16 < p.n; mt += WARPS) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bf16* a_row = as + (mt * 16 + (lane & 15)) * H_LD + (lane >> 4) * 8;
    const bf16* w_row = ps + (lane & 15) * W1_LD;
    for (int k0 = 0; k0 < E; k0 += 16) {
      uint32_t a[4], b[2];
      mit::ldmatrix_x4(a, a_row + k0);
      mit::ldmatrix_x2_trans(b, w_row + k0 * W1_LD);
      mit::mma_bf16(acc, a, b);
    }
    const int c = u * P_CT + 2 * (lane & 3);
    const float b0 = __ldg(p.b1 + c), b1 = __ldg(p.b1 + c + 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + (lane >> 2) + 8 * half;
      if (row < p.n)
        mit::store2(p.h + (size_t)row * E + c,
                    mit::gelu_erf(acc[2 * half] + b0),
                    mit::gelu_erf(acc[2 * half + 1] + b1));
    }
  }
  __syncthreads();
}

// phase 2 for one chunk: the N x 64 logit tile, then per row its max, sum
// of exp and top-TOPC
__device__ void vocab_chunk(const Params& p, int chunk, const bf16* hs,
                            const bf16* ws, float* lt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = chunk * CV;
  for (int mt = warp; mt * 16 < p.n; mt += WARPS) {
    float acc[CV / 8][4];
#pragma unroll
    for (int j = 0; j < CV / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const bf16* a_row = hs + (mt * 16 + (lane & 15)) * H_LD + (lane >> 4) * 8;
    const bf16* b_row =
        ws + ((lane & 7) + ((lane >> 4) << 3)) * H_LD + ((lane >> 3) & 1) * 8;
    for (int k0 = 0; k0 < E; k0 += 16) {
      uint32_t a[4];
      mit::ldmatrix_x4(a, a_row + k0);
#pragma unroll
      for (int j = 0; j < CV / 8; j += 2) {
        uint32_t b[4];
        mit::ldmatrix_x4(b, b_row + j * 8 * H_LD + k0);
        mit::mma_bf16(acc[j], a, b);
        mit::mma_bf16(acc[j + 1], a, b + 2);
      }
    }
    const int r0 = mt * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < CV / 8; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      mit::store2(lt + r0 * L_LD + c, acc[j][0], acc[j][1]);
      mit::store2(lt + (r0 + 8) * L_LD + c, acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  // 8 lanes per row, 4 rows per warp at a time: a lane holds columns
  // sub + 8j; max, sum of exp and 5 rounds of arg-max over 3 butterfly
  // steps inside the group
  const int sub = lane & (G - 1);
  for (int r0 = warp * 4; r0 < p.n; r0 += WARPS * 4) {
    const int row = r0 + (lane >> 3);
    const int rr = min(row, p.n - 1);
    float v[CV / G];
    int idx[CV / G];
#pragma unroll
    for (int j = 0; j < CV / G; ++j) {
      idx[j] = c0 + sub + G * j;
      v[j] = idx[j] < p.V ? lt[rr * L_LD + sub + G * j] + __ldg(p.bv + idx[j])
                          : -INFINITY;
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < CV / G; ++j) m = fmaxf(m, v[j]);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < CV / G; ++j) s += expf(v[j] - m);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const size_t base = (size_t)rr * p.n_chunks + chunk;
    const bool writer = row < p.n && sub == 0;
    if (writer) {
      p.pmax[base] = m;
      p.psum[base] = s;
    }
    for (int q = 0; q < TOPC; ++q) {
      float bvv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < CV / G; ++j)
        if (mit::topk_before(v[j], idx[j], bvv, bi)) {
          bvv = v[j];
          bi = idx[j];
        }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bvv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (mit::topk_before(ov, oi, bvv, bi)) {
          bvv = ov;
          bi = oi;
        }
      }
      if (writer) {
        p.pval[base * TOPC + q] = bvv;
        p.pidx[base * TOPC + q] = bi;
      }
#pragma unroll
      for (int j = 0; j < CV / G; ++j)
        if (idx[j] == bi) {
          v[j] = -INFINITY;
          idx[j] = 0x7fffffff;
        }
    }
  }
  __syncthreads();
}

// phase 3 for one row: logsumexp over the chunks, then the top-k of the
// chunks' candidates (partials written by other blocks: read past L1)
__device__ void merge_row(const Params& p, int row) {
  const int lane = threadIdx.x & 31;
  const float* rmax = p.pmax + (size_t)row * p.n_chunks;
  const float* rsum = p.psum + (size_t)row * p.n_chunks;
  float m = -INFINITY;
  for (int c = lane; c < p.n_chunks; c += 32) m = fmaxf(m, __ldcg(rmax + c));
  m = mit::warp_max(m);
  float s = 0.0f;
  for (int c = lane; c < p.n_chunks; c += 32)
    s += __ldcg(rsum + c) * expf(__ldcg(rmax + c) - m);
  s = mit::warp_sum(s);
  const float lse = m + logf(s);

  // each lane keeps the top TOPC of its candidates (c = lane, lane + 32,
  // ...) sorted in registers, read once; then k rounds take the best head
  // over the warp and pop it from the lane that holds it
  const int n_cand = p.n_chunks * TOPC;
  const float* cv = p.pval + (size_t)row * n_cand;
  const int* ci = p.pidx + (size_t)row * n_cand;
  float lv[TOPC];
  int li[TOPC];
#pragma unroll
  for (int t = 0; t < TOPC; ++t) {
    lv[t] = -INFINITY;
    li[t] = 0x7fffffff;
  }
#pragma unroll 4
  for (int c = lane; c < n_cand; c += 32) {
    float v = __ldcg(cv + c);
    int i = __ldcg(ci + c);
#pragma unroll
    for (int t = 0; t < TOPC; ++t)
      if (mit::topk_before(v, i, lv[t], li[t])) {
        const float tv = lv[t];
        const int ti = li[t];
        lv[t] = v;
        li[t] = i;
        v = tv;
        i = ti;
      }
  }
  for (int q = 0; q < p.k; ++q) {
    float bvv = lv[0];
    int bi = li[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bvv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (mit::topk_before(ov, oi, bvv, bi)) {
        bvv = ov;
        bi = oi;
      }
    }
    if (li[0] == bi && lv[0] == bvv) {
#pragma unroll
      for (int t = 0; t + 1 < TOPC; ++t) {
        lv[t] = lv[t + 1];
        li[t] = li[t + 1];
      }
      lv[TOPC - 1] = -INFINITY;
      li[TOPC - 1] = 0x7fffffff;
    }
    if (lane == 0) {
      p.out_val[(size_t)row * p.k + q] = bvv - lse;
      p.out_idx[(size_t)row * p.k + q] = (int64_t)bi;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) char_topk_persistent(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + H_BYTES);
  float* lt = reinterpret_cast<float*>(smem + H_BYTES + WV_BYTES);
  bf16* ps = reinterpret_cast<bf16*>(lt);   // W1 panel (phase 1 only)

  if ((int)blockIdx.x < p.n_chunks) {
    stage_wv(p, blockIdx.x, ws);
    mit::cp_commit();
  }
  for (int u = blockIdx.x; u < E / P_CT; u += gridDim.x)
    pred1_unit(p, u, hs, ps);
  mit::grid_sync(p.sync);

  bool h_staged = false;
  for (int chunk = blockIdx.x; chunk < p.n_chunks; chunk += gridDim.x) {
    if (chunk != (int)blockIdx.x) stage_wv(p, chunk, ws);
    if (!h_staged) stage_rows(p.h, p.n, hs);
    h_staged = true;
    mit::cp_commit();
    mit::cp_wait<0>();
    __syncthreads();
    vocab_chunk(p, chunk, hs, ws, lt);
  }
  mit::grid_sync(p.sync);

  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < p.n;
       row += gridDim.x * WARPS)
    merge_row(p, row);
}

int g_grid[16];   // blocks of a launch, per device (0: not yet known)

}  // namespace

// dec (n, 320) bf16; w1 (320, 320) bf16 [in, out]; b1 (320) f32;
// wv (V, 320) bf16; bv (V) f32; h scratch (n, 320) bf16;
// partial scratch: pmax/psum (n, n_chunks) f32, pval (n, n_chunks, 5) f32,
// pidx (n, n_chunks, 5) int32 with n_chunks = ceil(V / 64);
// outputs: out_val (n, k) f32, out_idx (n, k) int64; sync: >= 2 uint32,
// zero before the first launch; a launch's two barriers flip the barrier
// word's top bit twice, so it leaves the buffer as it found it (one buffer
// per device: launches that share it must not run concurrently).
// One cooperative launch of one block per SM.
extern "C" int mit_char_topk(const void* dec, const void* w1, const void* b1,
                             const void* wv, const void* bv, int n, int V,
                             int k, void* h, void* pmax, void* psum,
                             void* pval, void* pidx, void* out_val,
                             void* out_idx, void* sync, void* stream) {
  if (n < 1 || n > NMAX || V < k || k < 1 || k > TOPC)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  if (g_grid[dev] == 0) {
    e = cudaFuncSetAttribute(char_topk_persistent,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, char_topk_persistent, THREADS, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_grid[dev] = sms;   // one block per SM
  }
  Params p;
  p.dec = (const bf16*)dec;
  p.w1 = (const bf16*)w1;
  p.b1 = (const float*)b1;
  p.wv = (const bf16*)wv;
  p.bv = (const float*)bv;
  p.n = n;
  p.V = V;
  p.k = k;
  p.n_chunks = (V + CV - 1) / CV;
  p.h = (bf16*)h;
  p.pmax = (float*)pmax;
  p.psum = (float*)psum;
  p.pval = (float*)pval;
  p.pidx = (int*)pidx;
  p.out_val = (float*)out_val;
  p.out_idx = (int64_t*)out_idx;
  p.sync = (unsigned*)sync;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)char_topk_persistent,
                                  dim3(g_grid[dev]), dim3(THREADS), args,
                                  SMEM_BYTES, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
