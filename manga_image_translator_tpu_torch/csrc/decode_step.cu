// K2: one 48px-OCR decoder step (all 5 pre-LN layers) for Hopper (sm_90a),
// as one persistent kernel launch.
//
// Replaces: manga_image_translator_tpu/ops/pallas_decode.py,
//   decode_step_pallas (body _decode_kernel), including its fused beam
//   gather (fused_gather): here the beam's history is read through an
//   ancestry table instead of permuting the cache.
//
// One step, for N beam rows (E=320, 4 heads x 80, FF 2048, L=5):
//   per layer: LN1 -> fused QKV (q scaled by 80^-0.5 and XPOS-rotated, k
//   rotated; k/v written straight into the (L,S,N,E) cache at position
//   `step`) -> self-attention over positions 0..step -> out-proj +
//   residual -> LN2 -> cross-q (scaled, rotated) -> cross-attention over the
//   pre-rotated (L,M,N,E) memory with per-row lengths -> out-proj +
//   residual -> LN3 -> FF1 + ReLU -> FF2 + residual.
// bf16 storage, f32 accumulation, f32 LayerNorm/softmax/rotation.
//
// Ancestry: src (S, N) int32 names, for every beam row n and position
// t < step, the cache row that holds position t of n's history; position
// `step` is row n itself (written by this step's QKV phase). A null src is
// the identity. The beam loop updates the table after each selection and
// never moves the cache.
//
// The step is read from device memory (the JAX kernel's scalar prefetch
// `step_ref`), once per block, so a beam loop can advance it on the card
// and replay its steps as a CUDA graph. The kernel indexes the (S, 6, HD)
// XPOS table by it itself. A step outside 0..s_len-1 launches nothing of
// the step: block 0 writes the error word (err[0] = 1, err[1] = the step)
// and every block returns before its first barrier, outputs untouched.
//
// What bounds it on the H100: bytes. The step reads all decoder weights
// once, 5 x (4 E^2 + 2 E FF) x 2 B = 17.2 MB, plus the K/V rows it attends
// over: 5 x 2 x (step+1) x N x E x 2 B self plus 5 x 2 x M x N x E x 2 B
// cross (173 MB at step 128, N=120, M=96: 52 us at 3.35 TB/s). Its
// operations (2 N x 8.6 M weights = 2.1 GFLOP at N=120) are 2 us of bf16
// tensor-core time.
//
// Design: one cooperative launch, one 256-thread block per SM, that walks
// the 8 phases of each layer with a grid-wide barrier between phases (39
// a step). No library call, no atomics on values: a step gives the same
// bits on every run.
//   * GEMM phases (QKV, out-proj, cross-q, cross out-proj, FF1, FF2): the
//     output splits into units of 8, 16 or 32 columns (FF2 also into 8
//     slices of K); where that leaves blocks idle, the rows split into
//     groups of whole 16-row tiles too. Blocks take units round robin. A
//     unit stages its rows and its weight panel in shared memory by
//     cp.async (16 B, past L1), LayerNorms the rows in place where the
//     phase has one (8 lanes a row, the LN weights staged with the rows),
//     and multiplies on the tensor cores (mma.sync m16n8k16 bf16, A by
//     ldmatrix, B by ldmatrix.trans from the [in, out] panel; a warp owns a
//     16-row tile by 8 or 16 columns). The epilogue runs on the accumulator
//     registers, whose column pairs are the XPOS rotation's pairs: bias,
//     scale, rotation, ReLU, residual add, cache writes. Weights do not
//     depend on activations, so a block issues the copies of its next GEMM
//     phase's weight panel as soon as its current phase is done; they land
//     while the block waits at the barriers (and through an attention
//     phase).
//   * FF2 (K = 2048) stores per-slice f32 partial sums; the last block to
//     finish a tile (a per-tile counter that it resets) adds the 8 slices
//     in order 0..7, the bias and the residual.
//   * Attention phases: one warp per (row, head) item, positions in chunks
//     of 32: each lane copies one position's key and value rows (160 B
//     each; 20 cp.async of 16 B in flight per lane) into shared memory and
//     scores it; the chunk joins an exact f32 online softmax (running max
//     and sum); 3 groups of 10 lanes mix the value rows 8 dims per lane,
//     summed in a fixed order. Self-attention finds each position's row
//     through src.
#include <stdint.h>

#include "common.cuh"

namespace {

using mit::bf16;

constexpr int E = 320;
constexpr int NH = 4;
constexpr int HD = 80;
constexpr int NL = 5;
constexpr int FF = 2048;
constexpr int NMAX = 160;                // beam rows a launch serves
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FF2_SPLITS = 8;            // FF2's K slices of 256

constexpr int KR_MAX = 320;              // deepest K a unit stages
constexpr int A_LD_MAX = KR_MAX + 8;
constexpr size_t A_BYTES = sizeof(bf16) * (size_t)NMAX * A_LD_MAX;
constexpr int W_ELEMS = KR_MAX * 40;     // the largest panel: 256 x (32+8)
constexpr size_t SMEM_BYTES = A_BYTES + sizeof(bf16) * W_ELEMS;
static_assert(A_BYTES % 16 == 0, "weight panel must stay 16-byte aligned");

enum Epi { EPI_QKV, EPI_CROSSQ, EPI_RESID, EPI_RELU };

struct Params {
  int n, s_len, m_len;
  const long long* step;     // 0-d: the position this launch decodes
  bf16* x;                   // (n, E) step input, overwritten with output
  const bf16 *wqkv, *wo, *wcq, *wco, *w1, *w2;
  const float *bqkv, *bo, *bcq, *bco, *ln_w, *ln_b, *b1, *b2;
  const float* rot;          // (s_len, 6, HD): XPOS rows of every step
  bf16 *self_k, *self_v;     // (L, s_len, n, E)
  const bf16 *mem_k, *mem_v; // (L, m_len, n, E)
  const int* mem_len;        // (n)
  const int* src;            // (s_len, n) ancestry, or null
  bf16 *k_new, *v_new;       // (L, n, E)
  bf16 *q, *attn, *h;        // scratch (n, E), (n, E), (n, FF)
  float* partial;            // (FF2_SPLITS, n, E)
  unsigned* sync;            // [0] barrier, [2..63] FF2 tile counters
  int* err;                  // (2): set when the step is out of range
  long long* stamps;         // (2 x 40) SM clocks of block 0, or null
};

// the launch's step, read from p.step by thread 0 of each block at entry
__shared__ int s_step;

// block 0's SM clock at the start (2i) and at the end (2i + 1) of phase i
// (the 8 phases of each layer in order): where a step's time goes
__device__ __forceinline__ void stamp(const Params& p, int i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.stamps[i] = clock64();
}

struct Gemm {
  const bf16* a;        // (n, K) activation rows
  const bf16* w;        // (K, n_out) [in, out]
  const float* bias;    // (n_out)
  const float* ln_w;    // (K) or null: LayerNorm the rows first (K == E)
  const float* ln_b;
  int K, n_out, ct, kr, epi;
  int rgs, rg_rows;     // row groups per column tile, rows per group

  __device__ int col_tiles() const { return n_out / ct; }
  __device__ int splits() const { return K / kr; }
  __device__ int units() const { return col_tiles() * rgs * splits(); }
  __device__ int w_ld() const { return ct == 8 ? 24 : ct + 8; }
};

// what unit u of a phase covers: column tile, row range and K slice
struct Unit {
  int ct_i, rg, ks, r_beg, r_cnt;
  __device__ Unit(const Gemm& g, int u, int n) {
    ct_i = u % g.col_tiles();
    rg = (u / g.col_tiles()) % g.rgs;
    ks = u / (g.col_tiles() * g.rgs);
    r_beg = rg * g.rg_rows;
    r_cnt = min(n - r_beg, g.rg_rows);
  }
};

// phase i (0..5) of layer l: QKV, out-proj, cross-q, cross out-proj, FF1,
// FF2. Where the column tiles leave blocks idle, the rows split into
// groups (of whole 16-row tiles) too, so a unit stages, normalises and
// multiplies fewer rows.
__device__ Gemm layer_gemm(const Params& p, int l, int i) {
  const size_t ee = (size_t)E * E;
  Gemm g{};
  g.K = E;
  g.n_out = E;
  g.ct = 8;
  g.kr = E;
  switch (i) {
    case 0:
      g.a = p.x; g.w = p.wqkv + l * 3 * ee; g.bias = p.bqkv + l * 3 * E;
      g.ln_w = p.ln_w + (l * 3 + 0) * E; g.ln_b = p.ln_b + (l * 3 + 0) * E;
      g.n_out = 3 * E; g.ct = 16; g.epi = EPI_QKV;
      break;
    case 1:
      g.a = p.attn; g.w = p.wo + l * ee; g.bias = p.bo + l * E;
      g.epi = EPI_RESID;
      break;
    case 2:
      g.a = p.x; g.w = p.wcq + l * ee; g.bias = p.bcq + l * E;
      g.ln_w = p.ln_w + (l * 3 + 1) * E; g.ln_b = p.ln_b + (l * 3 + 1) * E;
      g.epi = EPI_CROSSQ;
      break;
    case 3:
      g.a = p.attn; g.w = p.wco + l * ee; g.bias = p.bco + l * E;
      g.epi = EPI_RESID;
      break;
    case 4:
      g.a = p.x; g.w = p.w1 + (size_t)l * E * FF; g.bias = p.b1 + l * FF;
      g.ln_w = p.ln_w + (l * 3 + 2) * E; g.ln_b = p.ln_b + (l * 3 + 2) * E;
      g.n_out = FF; g.ct = 32; g.epi = EPI_RELU;
      break;
    default:
      g.a = p.h; g.w = p.w2 + (size_t)l * FF * E; g.bias = p.b2 + l * E;
      g.K = FF; g.ct = 32; g.kr = FF / FF2_SPLITS; g.epi = EPI_RESID;
      break;
  }
  const int mtiles = (p.n + 15) / 16;
  const int rgs = max(1, min(mtiles, (int)gridDim.x /
                                         (g.col_tiles() * g.splits())));
  const int per = (mtiles + rgs - 1) / rgs;
  g.rg_rows = 16 * per;
  g.rgs = (mtiles + per - 1) / per;
  return g;
}

__device__ __forceinline__ float2 ldcg_bf2(const bf16* p) {
  const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// weight panel of unit u: rows [ks*kr, +kr) x columns [ct_i*ct, +ct)
__device__ void stage_w(const Gemm& g, int u, int n, bf16* Ws) {
  const Unit t(g, u, n);
  const int c8n = g.ct / 8, w_ld = g.w_ld();
  for (int i = threadIdx.x; i < g.kr * c8n; i += THREADS) {
    const int k = i / c8n, c8 = (i - k * c8n) * 8;
    mit::cp_async<16>(Ws + k * w_ld + c8,
                      g.w + (size_t)(t.ks * g.kr + k) * g.n_out +
                          t.ct_i * g.ct + c8,
                      16);
  }
}

// what an unsplit unit's epilogue reads, staged with its rows: the bias of
// its columns, the XPOS rows, the residual tile (out-proj: 8 columns)
struct UnitConsts {
  float bias[32];
  float rot[6 * HD];
  bf16 res[NMAX * 8];
};

// the unit's rows (its K slice), the LayerNorm weights if it has one, and
// its epilogue's constants
__device__ void stage_a(const Params& p, const Gemm& g, const Unit& t,
                        bf16* As, float* ln_s, UnitConsts& uc) {
  const int k8n = g.kr / 8, a_ld = g.kr + 8;
  for (int i = threadIdx.x; i < t.r_cnt * k8n; i += THREADS) {
    const int r = i / k8n, k8 = (i - r * k8n) * 8;
    mit::cp_async<16>(As + r * a_ld + k8,
                      g.a + (size_t)(t.r_beg + r) * g.K + t.ks * g.kr + k8,
                      16);
  }
  if (g.ln_w != nullptr) {
    for (int i = threadIdx.x; i < 2 * E / 4; i += THREADS) {
      const float* src = i < E / 4 ? g.ln_w + 4 * i : g.ln_b + 4 * i - E;
      mit::cp_async<16>(ln_s + 4 * i, src, 16);
    }
  }
  if (g.kr < g.K) return;   // split: the last block's sum reads them itself
  for (int i = threadIdx.x; i < g.ct / 4; i += THREADS)
    mit::cp_async<16>(uc.bias + 4 * i, g.bias + t.ct_i * g.ct + 4 * i, 16);
  if (g.epi == EPI_QKV || g.epi == EPI_CROSSQ) {
    for (int i = threadIdx.x; i < 6 * HD / 4; i += THREADS)
      mit::cp_async<16>(uc.rot + 4 * i,
                        p.rot + (size_t)s_step * 6 * HD + 4 * i, 16);
  } else if (g.epi == EPI_RESID) {   // ct == 8: one 16-byte piece a row
    for (int r = threadIdx.x; r < t.r_cnt; r += THREADS)
      mit::cp_async<16>(uc.res + 8 * r,
                        p.x + (size_t)(t.r_beg + r) * E + t.ct_i * g.ct, 16);
  }
}

// LayerNorm of the staged rows in place (K == E): 8 lanes per row, 4 rows
// per warp at a time; a lane keeps its 40 values in registers for the two
// passes
__device__ void layer_norm_rows(int rows, bf16* As, const float* ln_s) {
  constexpr int A_LD = E + 8;
  constexpr int PAIRS = E / 2 / 8;       // bf16 pairs per lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & 7;
  for (int r0 = warp * 4; r0 < rows; r0 += WARPS * 4) {
    const int r = min(r0 + (lane >> 3), rows - 1);
    __nv_bfloat162* row = reinterpret_cast<__nv_bfloat162*>(As + r * A_LD);
    float v[2 * PAIRS];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const float2 f = __bfloat1622float2(row[sub + 8 * i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
      s += f.x + f.y;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / E;
    float d = 0.0f;
#pragma unroll
    for (int i = 0; i < 2 * PAIRS; ++i) d += (v[i] - mean) * (v[i] - mean);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    const float rstd = rsqrtf(d / E + 1e-5f);
    // rows past the end read the last row again and store nothing
    if (r0 + (lane >> 3) < rows) {
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const int c = 2 * (sub + 8 * i);
        const float2 w = *reinterpret_cast<const float2*>(ln_s + c);
        const float2 b = *reinterpret_cast<const float2*>(ln_s + E + c);
        row[sub + 8 * i] = __floats2bfloat162_rn(
            (v[2 * i] - mean) * rstd * w.x + b.x,
            (v[2 * i + 1] - mean) * rstd * w.y + b.y);
      }
    }
  }
}

// scale, rotation (rt: the step's 6 XPOS rows), ReLU, residual and the
// stores of the column pair (c, c+1) of row `row`; v0, v1 hold the bias
__device__ __forceinline__ void epilogue(const Params& p, const Gemm& g,
                                         int l, int row, int c, float v0,
                                         float v1, const float* rt,
                                         float2 res) {
  const float scale = 0.11180339887498948f;   // 80^-0.5
  const float* rot = nullptr;                 // sin row; cos = sin + HD
  bf16* out = nullptr;
  bf16* out2 = nullptr;
  int oc = c;
  switch (g.epi) {
    case EPI_QKV: {
      const int seg = c / E;
      oc = c - seg * E;
      const size_t at = ((size_t)(l * p.s_len + s_step) * p.n + row) * E + oc;
      const size_t at_new = ((size_t)l * p.n + row) * E + oc;
      if (seg == 0) {
        v0 *= scale;
        v1 *= scale;
        rot = rt;
        out = p.q + (size_t)row * E + oc;
      } else if (seg == 1) {
        rot = rt + 2 * HD;
        out = p.self_k + at;
        out2 = p.k_new + at_new;
      } else {
        out = p.self_v + at;
        out2 = p.v_new + at_new;
      }
      break;
    }
    case EPI_CROSSQ:
      v0 *= scale;
      v1 *= scale;
      rot = rt + 4 * HD;
      out = p.q + (size_t)row * E + c;
      break;
    case EPI_RESID:
      out = p.x + (size_t)row * E + c;
      v0 += res.x;
      v1 += res.y;
      break;
    default:
      v0 = fmaxf(v0, 0.0f);
      v1 = fmaxf(v1, 0.0f);
      out = p.h + (size_t)row * FF + c;
      break;
  }
  if (rot != nullptr) {
    const int j = oc % HD;
    const float* sn = rot;
    const float* cs = rot + HD;
    const float r0 = v0 * cs[j] - v1 * sn[j];
    const float r1 = v1 * cs[j + 1] + v0 * sn[j + 1];
    v0 = r0;
    v1 = r1;
  }
  mit::store2(out, v0, v1);
  if (out2 != nullptr) mit::store2(out2, v0, v1);
}

// the unit's product on the tensor cores and its epilogue; NT = ct / 8.
// A warp's item is one 16-row tile by 8 columns (NT = 1) or 16 columns.
template <int NT>
__device__ void unit_product(const Params& p, const Gemm& g, int l,
                             const Unit& t, const bf16* As, const bf16* Ws,
                             const UnitConsts& uc) {
  constexpr int NI = NT == 1 ? 1 : 2;    // n8 tiles per item
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a_ld = g.kr + 8, w_ld = g.w_ld();
  const int mtiles = (t.r_cnt + 15) / 16;
  const bool split = g.kr < g.K;
  for (int it = warp; it < mtiles * (NT / NI); it += WARPS) {
    const int mt = it / (NT / NI), nb = (it - mt * (NT / NI)) * NI;
    float acc[NI][4];
#pragma unroll
    for (int j = 0; j < NI; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const bf16* a_row = As + (mt * 16 + (lane & 15)) * a_ld + (lane >> 4) * 8;
    const bf16* w_row = Ws + (lane & 15) * w_ld + nb * 8;
    for (int k0 = 0; k0 < g.kr; k0 += 16) {
      uint32_t a[4];
      mit::ldmatrix_x4(a, a_row + k0);
      if constexpr (NI == 1) {
        uint32_t b[2];
        mit::ldmatrix_x2_trans(b, w_row + k0 * w_ld);
        mit::mma_bf16(acc[0], a, b);
      } else {
        uint32_t b[4];
        mit::ldmatrix_x4_trans(b, w_row + k0 * w_ld + (lane >> 4) * 8);
        mit::mma_bf16(acc[0], a, b);
        mit::mma_bf16(acc[1], a, b + 2);
      }
    }
    const int r0 = t.r_beg + mt * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int c = t.ct_i * g.ct + (nb + j) * 8 + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row >= t.r_beg + t.r_cnt) continue;
        const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
        if (split) {
          mit::store2(p.partial + ((size_t)t.ks * p.n + row) * E + c, v0, v1);
        } else {
          const int cl = c - t.ct_i * g.ct;
          float2 res = make_float2(0.0f, 0.0f);
          if (g.epi == EPI_RESID)
            res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                uc.res + 8 * (row - t.r_beg) + cl));
          epilogue(p, g, l, row, c, v0 + uc.bias[cl], v1 + uc.bias[cl + 1],
                   uc.rot, res);
        }
      }
    }
  }
}

// the last block to finish a split tile (column tile x row group) adds the
// FF2_SPLITS K slices in order 0, 1, ..., then the bias and the residual
__device__ void finish_split(const Params& p, const Gemm& g, int l,
                             const Unit& t, int* s_last) {
  unsigned* counter = p.sync + 2 + t.rg * g.col_tiles() + t.ct_i;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(counter, 1u) == (unsigned)(FF2_SPLITS - 1);
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  const int quads = g.ct / 4;
  const size_t slab = (size_t)p.n * E;
  for (int i = threadIdx.x; i < t.r_cnt * quads; i += THREADS) {
    const int row = t.r_beg + i / quads;
    const int c = t.ct_i * g.ct + (i % quads) * 4;
    const float* src = p.partial + (size_t)row * E + c;
    float4 z[FF2_SPLITS];
#pragma unroll
    for (int k = 0; k < FF2_SPLITS; ++k)
      z[k] = __ldcg(reinterpret_cast<const float4*>(src + k * slab));
    float4 s = z[0];
#pragma unroll
    for (int k = 1; k < FF2_SPLITS; ++k) {
      s.x += z[k].x;
      s.y += z[k].y;
      s.z += z[k].z;
      s.w += z[k].w;
    }
    const bf16* x = p.x + (size_t)row * E + c;
    epilogue(p, g, l, row, c, s.x + __ldg(g.bias + c),
             s.y + __ldg(g.bias + c + 1), nullptr, ldcg_bf2(x));
    epilogue(p, g, l, row, c + 2, s.z + __ldg(g.bias + c + 2),
             s.w + __ldg(g.bias + c + 3), nullptr, ldcg_bf2(x + 2));
  }
  if (threadIdx.x == 0) atomicExch(counter, 0u);
}

// one GEMM phase; ends by issuing the weight copies of the block's first
// unit of `next` (null: none), whose panel this phase's first unit found
// staged already
__device__ void gemm_phase(const Params& p, const Gemm& g, int l,
                           const Gemm* next, bf16* As, bf16* Ws, float* ln_s,
                           UnitConsts& uc, int* s_last) {
  for (int u = blockIdx.x; u < g.units(); u += gridDim.x) {
    const Unit t(g, u, p.n);
    if (u != (int)blockIdx.x) stage_w(g, u, p.n, Ws);
    stage_a(p, g, t, As, ln_s, uc);
    mit::cp_commit();
    mit::cp_wait<0>();
    __syncthreads();
    if (g.ln_w != nullptr) {
      layer_norm_rows(t.r_cnt, As, ln_s);
      __syncthreads();
    }
    switch (g.ct) {
      case 8: unit_product<1>(p, g, l, t, As, Ws, uc); break;
      case 16: unit_product<2>(p, g, l, t, As, Ws, uc); break;
      default: unit_product<4>(p, g, l, t, As, Ws, uc); break;
    }
    if (g.kr < g.K) finish_split(p, g, l, t, s_last);
    __syncthreads();
  }
  if (next != nullptr && (int)blockIdx.x < next->units()) {
    stage_w(*next, blockIdx.x, p.n, Ws);
    mit::cp_commit();
  }
}

// the row of the cache that holds position t of beam row n's history
__device__ __forceinline__ int history_row(const Params& p, bool self, int t,
                                           int n) {
  return (self && p.src != nullptr && t < s_step) ? __ldg(p.src + t * p.n + n)
                                                  : n;
}

// per-warp attention scratch (in the activation tile): 32 key and 32 value
// rows (rows padded to 176 B: a lane's 16-byte reads of its own row hit
// distinct banks), q, the chunk's weights, the value groups' sums
constexpr int KV_LD = HD + 8;
constexpr int CHUNK = 32;
constexpr size_t ATT_BYTES = sizeof(bf16) * 2 * CHUNK * KV_LD +
                             sizeof(float) * (HD + CHUNK + 3 * HD);
static_assert(ATT_BYTES * WARPS <= A_BYTES,
              "attention scratch must fit the activation tile");
static_assert(ATT_BYTES % 16 == 0, "attention scratch must stay aligned");

// two warps of a block per (row, head) item (warps w and w + 4 take the
// even and the odd chunks of 32 positions): self-attention over positions
// 0..step (through the ancestry table) or cross-attention over the first
// mem_len[row] memory positions. Each lane copies one position's key and
// value rows (cp.async, 20 x 16 B in flight per lane) and scores it from
// shared memory; the chunk joins the warp's exact f32 online softmax
// (running max and sum, rescaled sums); 3 groups of 10 lanes mix the value
// rows, 8 dims per lane. The odd warp hands its max, sum and 80 sums to the
// even one through shared memory (a 64-thread named barrier per pair),
// which merges them: a fixed order throughout.
__device__ void attention_phase(const Params& p, int l, bool self,
                                unsigned char* wsm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* ks = reinterpret_cast<bf16*>(wsm);
  bf16* vs = ks + CHUNK * KV_LD;
  float* qs = reinterpret_cast<float*>(vs + CHUNK * KV_LD);
  float* pw = qs + HD;
  float* part = pw + CHUNK;
  const int stride = self ? p.s_len : p.m_len;
  const bf16* kl = (self ? p.self_k : p.mem_k) + (size_t)l * stride * p.n * E;
  const bf16* vl = (self ? p.self_v : p.mem_v) + (size_t)l * stride * p.n * E;
  const size_t pstride = (size_t)p.n * E;
  const int g = lane / 10, c = lane - 10 * (lane / 10);  // value lanes < 30
  const int pair = warp & 3, half = warp >> 2;
  const float* other = reinterpret_cast<const float*>(
      reinterpret_cast<const unsigned char*>(part) + 4 * ATT_BYTES);
  // items spread over the blocks first, so every SM gets its share
  for (int item = pair * gridDim.x + blockIdx.x; item < p.n * NH;
       item += gridDim.x * (WARPS / 2)) {
    const int n = item / NH, hh = item - n * NH;
    const int T = self ? s_step + 1 : min(max(__ldg(p.mem_len + n), 0), p.m_len);
    bf16* out = p.attn + (size_t)n * E + hh * HD;
    if (T == 0) {
      for (int d = lane; d < HD; d += 32) out[d] = __float2bfloat16(0.0f);
      continue;
    }
    for (int d = lane; d < HD / 2; d += 32) {
      const float2 f = ldcg_bf2(p.q + (size_t)n * E + hh * HD + 2 * d);
      qs[2 * d] = f.x;
      qs[2 * d + 1] = f.y;
    }
    const size_t col = (size_t)hh * HD;
    float m = -INFINITY, sum = 0.0f;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int c0 = half * CHUNK; c0 < T; c0 += 2 * CHUNK) {
      const int cnt = min(CHUNK, T - c0);
      if (lane < cnt) {
        const int tt = c0 + lane;
        const size_t off = tt * pstride +
                           (size_t)history_row(p, self, tt, n) * E + col;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          mit::cp_async<16>(ks + lane * KV_LD + 8 * i, kl + off + 8 * i, 16);
          mit::cp_async<16>(vs + lane * KV_LD + 8 * i, vl + off + 8 * i, 16);
        }
      }
      mit::cp_commit();
      mit::cp_wait<0>();
      __syncwarp();
      float s = -INFINITY;
      if (lane < cnt) {
        s = 0.0f;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          const uint4 u = *reinterpret_cast<const uint4*>(ks + lane * KV_LD +
                                                          8 * i);
          const float4 qa = *reinterpret_cast<const float4*>(qs + 8 * i);
          const float4 qb = *reinterpret_cast<const float4*>(qs + 8 * i + 4);
          const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
          const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j) s += qv[j] * __bfloat162float(e[j]);
        }
      }
      const float m_new = fmaxf(m, mit::warp_max(s));
      const float corr = expf(m - m_new);
      const float pe = lane < cnt ? expf(s - m_new) : 0.0f;
      sum = sum * corr + mit::warp_sum(pe);
      pw[lane] = pe;
      __syncwarp();
      if (lane < 30) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] *= corr;
        for (int tt = g; tt < cnt; tt += 3) {
          const float w = pw[tt];
          const uint4 u = *reinterpret_cast<const uint4*>(vs + tt * KV_LD +
                                                          8 * c);
          const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] += w * __bfloat162float(e[j]);
        }
      }
      m = m_new;
      __syncwarp();
    }
    if (lane < 30) {
#pragma unroll
      for (int j = 0; j < 8; ++j) part[g * HD + c * 8 + j] = acc[j];
    }
    __syncwarp();
    float o[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int d = lane + 32 * i;
      o[i] = d < HD ? part[d] + part[HD + d] + part[2 * HD + d] : 0.0f;
    }
    if (half == 1) {   // hand over: the 80 sums, the max, the sum
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (lane + 32 * i < HD) part[lane + 32 * i] = o[i];
      if (lane == 0) {
        part[HD] = m;
        part[HD + 1] = sum;
      }
    }
    asm volatile("bar.sync %0, 64;" ::"r"(1 + pair));
    if (half == 0) {
      const float m1 = other[HD], s1 = other[HD + 1];
      const float mm = fmaxf(m, m1);
      const float e0 = expf(m - mm), e1 = expf(m1 - mm);
      const float inv = 1.0f / (sum * e0 + s1 * e1);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int d = lane + 32 * i;
        if (d < HD)
          out[d] = __float2bfloat16((o[i] * e0 + other[d] * e1) * inv);
      }
    }
    asm volatile("bar.sync %0, 64;" ::"r"(1 + pair));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
decode_step_persistent(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = reinterpret_cast<bf16*>(smem + A_BYTES);
  unsigned char* wsm = smem + (threadIdx.x >> 5) * ATT_BYTES;
  __shared__ __align__(16) float ln_s[2 * E];
  __shared__ __align__(16) UnitConsts uc;
  __shared__ int s_last;

  // the first weight panel does not depend on the step: its copies are
  // in flight while thread 0 reads the step
  Gemm g = layer_gemm(p, 0, 0);
  if ((int)blockIdx.x < g.units()) {
    stage_w(g, blockIdx.x, p.n, Ws);
    mit::cp_commit();
  }
  if (threadIdx.x == 0) {
    const long long step = *p.step;
    const bool ok = step >= 0 && step < p.s_len;
    s_step = ok ? (int)step : -1;
    if (!ok && blockIdx.x == 0) {
      p.err[1] = (int)step;
      p.err[0] = 1;
    }
  }
  __syncthreads();
  if (s_step < 0) {         // every block, before its first barrier
    mit::cp_wait<0>();
    return;
  }
  int ph = 0;
  stamp(p, 0);
  for (int l = 0; l < NL; ++l) {
    for (int i = 0; i < 6; ++i) {
      const bool last = (l == NL - 1 && i == 5);
      const Gemm next = layer_gemm(p, i == 5 ? l + 1 : l, (i + 1) % 6);
      gemm_phase(p, g, l, last ? nullptr : &next, As, Ws, ln_s, uc,
                 &s_last);
      stamp(p, 2 * ph + 1);
      if (last) break;
      mit::grid_sync(p.sync);
      stamp(p, 2 * ++ph);
      if (i == 0 || i == 2) {   // self- after QKV, cross- after cross-q
        attention_phase(p, l, i == 0, wsm);
        stamp(p, 2 * ph + 1);
        mit::grid_sync(p.sync);
        stamp(p, 2 * ++ph);
      }
      g = next;
    }
  }
}

int g_grid[16];   // blocks of a launch, per device (0: not yet known)

}  // namespace

// Weights (stacked over the 5 layers, [in, out] layouts, bf16 unless noted):
//   wqkv (L, E, 3E), bqkv (L, 3E) f32, wo (L, E, E), bo (L, E) f32,
//   wcq (L, E, E), bcq f32, wco (L, E, E), bco f32, ln_w/ln_b (L, 3, E) f32,
//   w1 (L, E, FF), b1 (L, FF) f32, w2 (L, FF, E), b2 (L, E) f32.
// step: a 0-d int64 in device memory, the position to decode.
// rot: (s_len, 6, HD) f32 XPOS rows of every step: self-q sin/cos, self-k
//   sin/cos, cross-q sin/cos.
// tgt (n, E): the step input, overwritten with the step output.
// self_k/self_v (L, s_len, n, E); mem_k/mem_v (L, m_len, n, E); mem_len (n)
// int32; src (s_len, n) int32 ancestry or null (identity); k_new/v_new
// (L, n, E) outputs; scratch: q_buf, attn_buf (n, E), h_buf (n, FF) bf16,
// partial (8, n, E) f32; sync: 64 uint32, zero before the first launch:
// every launch leaves the FF2 tile counters zero and the barrier word's
// low 31 bits as found, and flips its top bit (39 barriers; grid_sync
// waits for a flip relative to the value it read) (one buffer per device:
// launches that share it must not run concurrently); err: 2 int32, set to
// (1, step) by a launch whose step is outside 0..s_len-1 (the caller reads
// and clears it); stamps: null, or
// (80) int64 that
// receive block 0's SM clock at the start and end of each phase.
// One cooperative launch of one block per SM; returns the launch's
// cudaError_t (cudaErrorCooperativeLaunchTooLarge if the blocks cannot all
// be resident), cudaErrorInvalidValue for a shape it does not serve. The
// launch path makes no allocation and no synchronous call, so a stream
// capture can record it (the kernel's attributes are set at the first
// call on a device, which a beam loop makes before it captures).
extern "C" int mit_decode_step(
    int n, int s_len, int m_len, const void* step, void* tgt, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* wcq,
    const void* bcq, const void* wco, const void* bco, const void* ln_w,
    const void* ln_b, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* rot, void* self_k, void* self_v,
    const void* mem_k, const void* mem_v, const void* mem_len,
    const void* src, void* k_new, void* v_new, void* q_buf, void* attn_buf,
    void* h_buf, void* partial, void* sync, void* err, void* stamps,
    void* stream) {
  if (n < 1 || n > NMAX || s_len < 1 || m_len < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  if (g_grid[dev] == 0) {
    e = cudaFuncSetAttribute(decode_step_persistent,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_step_persistent, THREADS, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_grid[dev] = sms;   // one block per SM
  }
  Params p;
  p.n = n;
  p.s_len = s_len;
  p.m_len = m_len;
  p.step = (const long long*)step;
  p.x = (bf16*)tgt;
  p.wqkv = (const bf16*)wqkv;
  p.wo = (const bf16*)wo;
  p.wcq = (const bf16*)wcq;
  p.wco = (const bf16*)wco;
  p.w1 = (const bf16*)w1;
  p.w2 = (const bf16*)w2;
  p.bqkv = (const float*)bqkv;
  p.bo = (const float*)bo;
  p.bcq = (const float*)bcq;
  p.bco = (const float*)bco;
  p.ln_w = (const float*)ln_w;
  p.ln_b = (const float*)ln_b;
  p.b1 = (const float*)b1;
  p.b2 = (const float*)b2;
  p.rot = (const float*)rot;
  p.self_k = (bf16*)self_k;
  p.self_v = (bf16*)self_v;
  p.mem_k = (const bf16*)mem_k;
  p.mem_v = (const bf16*)mem_v;
  p.mem_len = (const int*)mem_len;
  p.src = (const int*)src;
  p.k_new = (bf16*)k_new;
  p.v_new = (bf16*)v_new;
  p.q = (bf16*)q_buf;
  p.attn = (bf16*)attn_buf;
  p.h = (bf16*)h_buf;
  p.partial = (float*)partial;
  p.sync = (unsigned*)sync;
  p.err = (int*)err;
  p.stamps = (long long*)stamps;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)decode_step_persistent,
                                  dim3(g_grid[dev]), dim3(THREADS), args,
                                  SMEM_BYTES, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
