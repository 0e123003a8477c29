// One whole Macaron Conformer layer of the streaming step, for Hopper.
//
// Replaces the Pallas TPU kernel tone_tpu/ops/fused_layer.py
// `fused_conformer_layer` (pallas_call :445, body `_make_kernel` :216-375):
// FF1 -> rotary MHSA (score reuse, sliding window, invalid-prefix mask) ->
// GLU + causal depthwise conv + folded BatchNorm -> FF2 -> output RMSNorm,
// for a batch of streams, in one launch.
// Its rounding points are those of `fused_conformer_layer_plain`
// (tone_tpu_torch/ops/fused_layer.py), which the tests hold to the JAX kernel:
//   * RMSNorm: float32 sum of squares, divide by sqrt(sum)/sqrt(d) + 1e-8,
//     times the weight, round to bf16;
//   * projections: bf16 operands, float32 sums, float32 bias, float32 out;
//   * residual: float32; each sub-block sets res = bf16(res) + bf16(y)
//     (y halved in the feed-forwards) and the next RMSNorm reads it as is;
//   * FF gate silu(lin1) * linv in float32, rounded only as lin2's operand;
//   * q, k: per-head LayerNorm (eps 1e-5) and rotate-half RoPE in float32,
//     then bf16; scores = dot(q, k) in float32 times 1/sqrt(d_head); keys
//     before `invalid` get -1e4 before the float32 softmax and 0 after it;
//     attention weights and v in bf16, ctx summed in float32;
//   * conv: GLU rounded to bf16; 31 taps summed in order in float32, then
//     the bias, the BatchNorm scale/shift and SiLU in float32.
// expf and sqrtf (not the fast intrinsics), round-to-nearest-even casts.
//
// Shapes (row-major): x, y (B, T, D) bf16; conv state in/out (B, K-1, D)
// bf16; window in/out (B, W, D) bf16; invalid (B,) int32; scores in/out
// (B, H, T, W+T) fp32.  Weights: `mats` (bf16) and `vecs` (fp32) packed by
// flatten_layer_params, offsets in FusedLayerArgs.  On the main path
// D = 384, H = 8 (d_head 48), F = 1536, K = 31, T = 10 and W in {0, 30}, or
// T = 5 and W in {0, 15} in the reduced layers: 16 launches per step.
//
// Bound on an H100 SXM (3.35 TB/s, 989 dense bf16 TFLOP/s): a full-rate
// recompute layer at B = 64 reads 9.2 MB of weights and about 3 MB of
// activations and state, and does about 5.9 GFLOP, so it is bound by
// operations at about 6 us (at B = 16 by bytes, at about 3 us).  The weights
// dominate the bytes: each element meets only T = 10 or 5 rows per stream,
// so a design that reads them once per stream (one block per stream) moves
// B times the bound's bytes and runs on CUDA cores at one SM per stream.
//
// Design: one persistent cooperative launch per layer whose grid is sized
// to the card (SMs x resident blocks, from the occupancy query), not to B.
// The layer runs as 15 stages separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()); every block reaches every
// barrier, with or without work in the stage.  Between stages the
// intermediates live in a global scratch buffer that the wrapper allocates
// and that stays in L2 at these sizes (at most 14.3 MB at B = 64): the fp32
// residual, the bf16 activation that the next projection reads, the FF
// hidden (and later the conv GLU), raw fp32 q and k, bf16 v, and the fp32
// outputs of the projections that end a sub-block.
//   * Projections (FF up/down, q, k, v, out, pw1, pw2): tiles of 64 rows
//     (several streams) x 64 (feed-forward) or 32 columns, handed out
//     grid-stride; k and v share each A tile.  A and weight
//     tiles of depth 64 come into shared memory through a 4-stage cp.async
//     ring, so the next tiles load while 8 warps run bf16 mma.sync
//     m16n8k16 (fragments by ldmatrix) with fp32 accumulators on the
//     current ones; the epilogue works from the accumulator registers.
//     Each weight tile feeds 64 rows, and the layer's weights come from HBM
//     about once per launch.  The k and v tiles read their rows from
//     [window | chunk] directly (no concatenated copy).
//   * FF down (depth d_ff = 1536) is split in up to 4 depth slices, so its
//     serial chain of tile steps is as short as the others'; each slice
//     writes its own fp32 partial, and the row stage after it adds them in
//     slice order.  No element is summed by two blocks and nothing uses
//     atomics: results are bit-for-bit repeatable.
//   * Row stages (one warp per row) end each sub-block: they add its
//     projection (partials, bias, x0.5 in the feed-forwards) to the
//     residual as bf16(res) + bf16(y) and compute the next RMSNorm, so the
//     matmul epilogues only store.
//   * Attention: one block per (stream, head): head LayerNorm + RoPE of its
//     q and k rows, scores, mask, softmax and ctx in shared memory on CUDA
//     cores (T <= 10, W+T <= 40, d_head 48).  Depthwise conv: one block per
//     (stream, 128 channels), its padded rows and taps staged in shared
//     memory.
// Data written in one stage and read in a later one is read through L2
// (cp.async.cg, __ldcg), never through a possibly stale L1 line.
//
// Built with -DFL_STAGE_CLOCK, block 0 records the global timer after each
// barrier (tone_fused_layer_stage_ns), for a per-stage breakdown.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "fused_layer_plan.cuh"

namespace cg = cooperative_groups;

extern "C" {
struct FusedLayerArgs {
  int t, window, d, f, n_heads, rope_dim, conv_k, recompute;
  // bf16 matrices: element offsets into `mats`
  int ff1_w1, ff1_wv, ff1_w2, wq, wk, wv, wout, pw1, dw, pw2, ff2_w1, ff2_wv, ff2_w2;
  // fp32 vectors: element offsets into `vecs`
  int n_ff1, ff1_b1, ff1_bv, ff1_b2, n_att, bq, bk, qln_s, qln_b, kln_s, kln_b, cos_q,
      sin_q, cos_k, sin_k, bv, bout, n_conv, pw1_b, dw_b, bn_scale, bn_shift, pw2_b, n_ff2,
      ff2_b1, ff2_bv, ff2_b2, n_out;
};

// Byte offsets of the scratch buffers (ops/fused_layer.py plan_launch) and
// the scratch's size.  M = B*T rows, MKV = B*(W+T) rows, S the FF down
// projection's depth slices.
struct FusedLayerScratch {
  long long res;   // (M, D) fp32 residual
  long long act;   // (M, D) bf16: the operand of the next d_model-deep projection
  long long hid;   // (M, F) bf16 FF hidden; (M, D) conv GLU in the conv module
  long long qf;    // (M, D) fp32 q before its head norm (recompute layers)
  long long kf;    // (MKV, D) fp32 k before its head norm (recompute layers)
  long long v;     // (MKV, D) bf16 v
  long long part;  // (S, M, D) fp32 outputs of a sub-block's last projection
  long long total;
};
}

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = FL_THREADS / 32;
constexpr int A_LD = FL_BK + 8;  // padded shared-memory rows (bf16 elements)

template <int NW, int BN>
constexpr int ring_bytes() {
  return FL_STAGES * (FL_BM * A_LD + NW * FL_BK * (BN + 8)) * 2;
}
static_assert(ring_bytes<2, FL_BN_FF>() <= FL_SMEM, "FF-up ring fits");
static_assert(ring_bytes<2, FL_BN>() <= FL_SMEM, "pw1 ring fits");
static_assert(WARPS == 8 && FL_BM == 64, "8 warps: 4 row strips x 2 column halves");
static_assert(FL_BN_FF % 32 == 0 && FL_BN % 32 == 0, "each warp owns BN/2 columns");

struct Params {
  const bf16* x;
  const bf16* conv_in;
  const bf16* win_in;
  const int* invalid;
  const float* scores_in;
  const bf16* mats;
  const float* vecs;
  bf16* y;
  bf16* conv_out;
  bf16* win_out;
  float* scores_out;
  float* res;
  bf16* act;
  bf16* hid;
  float* qf;
  float* kf;
  bf16* v;
  float* part;
  FusedLayerArgs p;
  int batch;
  int ff_split;
  float inv_sqrt_dh;
};

#ifdef FL_STAGE_CLOCK
__device__ unsigned long long stage_ns[32];
__device__ __forceinline__ void stage_mark(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stage_ns[i] = t;
  }
}
#else
__device__ __forceinline__ void stage_mark(int) {}
#endif

__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }
__device__ __forceinline__ float siluf(float v) { return v * sigmoidf(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Global -> shared staging: the block's `count` 16-byte vectors, vector idx
// read by load(idx) and placed by store(idx, value).  A thread issues up to
// N loads before it stores any, so their latencies overlap.
template <int N, class Load, class Store>
__device__ void stage_vectors(int count, const Load& load, const Store& store) {
  for (int base = threadIdx.x; base < count; base += N * FL_THREADS) {
    uint4 buf[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (base + u * FL_THREADS < count) buf[u] = load(base + u * FL_THREADS);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (base + u * FL_THREADS < count) store(base + u * FL_THREADS, buf[u]);
    }
  }
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& raw, float* dst) {
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    dst[2 * u] = __low2float(r2[u]);
    dst[2 * u + 1] = __high2float(r2[u]);
  }
}

// ---------------------------------------------------------------------------
// One matmul tile: for rows row0 .. row0+63 (< rows) and columns
// col0 .. col0+BN-1, NW products sharing A,
//   out_m(r, j) = sum_k A[r][k] W_m[k][j] (+ b_m[j] where b_m is given),
// handed to epi(r, j, out_0) or epi(r, j, out_0, out_1).  A's rows come from
// arow(r) (bf16, kdim long); W_m is (kdim x N) bf16 with row stride ldw.
// kdim is a multiple of FL_BK.
// ---------------------------------------------------------------------------

struct RowsOf {  // rows of a row-major matrix
  const bf16* base;
  int ld;
  __device__ const bf16* operator()(int r) const { return base + (size_t)r * ld; }
};

struct KvRows {  // row b*(W+T)+c of [window | chunk]: window row c, or chunk row c-W
  const bf16* win;
  const bf16* act;
  int t, w, d;
  __device__ const bf16* operator()(int r) const {
    const int b = r / (w + t), c = r % (w + t);
    return c < w ? win + ((size_t)b * w + c) * d : act + ((size_t)b * t + c - w) * d;
  }
};

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c += a (16x16, row) * b (16x8, col): bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NW, int BN, class ARow, class Epi>
__device__ void mm_tile(const ARow& arow, int rows, int kdim, int tile_m, int col0,
                        const bf16* __restrict__ W0, const bf16* __restrict__ W1, int ldw,
                        const float* __restrict__ b0, const float* __restrict__ b1,
                        const Epi& epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int W_LD = BN + 8;
  constexpr int A_ELEMS = FL_BM * A_LD, W_ELEMS = FL_BK * W_LD;
  constexpr int STAGE_ELEMS = A_ELEMS + NW * W_ELEMS;
  constexpr int NT = BN / 16;  // 8-column accumulator tiles per warp and product
  constexpr int A_CP = FL_BM * FL_BK / 8 / FL_THREADS;  // 16-byte copies per thread
  constexpr int W_CP = FL_BK * BN / 8 / FL_THREADS;
  static_assert(A_CP * FL_THREADS * 8 == FL_BM * FL_BK, "A tile splits evenly");
  static_assert(W_CP * FL_THREADS * 8 == FL_BK * BN, "W tile splits evenly");
  static_assert(NT % 2 == 0, "B fragments load in pairs of 8-column tiles");

  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = tile_m * FL_BM;
  const bf16* const Ws[2] = {W0, W1};

  // A thread copies the same rows and columns at every depth step.
  const bf16* a_src[A_CP];
  int a_dst[A_CP];
  bool a_ok[A_CP];
#pragma unroll
  for (int i = 0; i < A_CP; ++i) {
    const int idx = tid + i * FL_THREADS;
    const int r = idx / (FL_BK / 8), c = (idx % (FL_BK / 8)) * 8;
    a_ok[i] = row0 + r < rows;
    a_src[i] = arow(a_ok[i] ? row0 + r : 0) + c;  // ragged rows: zero-filled
    a_dst[i] = r * A_LD + c;
  }
  int w_row[W_CP], w_col[W_CP];
#pragma unroll
  for (int i = 0; i < W_CP; ++i) {
    const int idx = tid + i * FL_THREADS;
    w_row[i] = idx / (BN / 8);
    w_col[i] = (idx % (BN / 8)) * 8;
  }
  auto load = [&](int slot, int k0) {
    bf16* st = ring + slot * STAGE_ELEMS;
#pragma unroll
    for (int i = 0; i < A_CP; ++i) cp_async16(st + a_dst[i], a_src[i] + k0, a_ok[i]);
#pragma unroll
    for (int m = 0; m < NW; ++m) {
#pragma unroll
      for (int i = 0; i < W_CP; ++i) {
        cp_async16(st + A_ELEMS + m * W_ELEMS + w_row[i] * W_LD + w_col[i],
                   Ws[m] + (size_t)(k0 + w_row[i]) * ldw + col0 + w_col[i], true);
      }
    }
  };

  // Warp (strip, half) computes rows wr .. wr+15 and columns wc .. wc+BN/2-1
  // of each product with mma.sync m16n8k16; its fragments come from
  // ldmatrix (A as stored, W transposed).
  const int wr = (warp / 2) * 16, wc = (warp % 2) * (BN / 2);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned a_lane = ((wr + lane % 16) * A_LD + (lane / 16) * 8) * 2;
  const unsigned b_lane = ((lane % 8 + ((lane / 8) % 2) * 8) * W_LD + wc + (lane / 16) * 8) * 2;
  float acc[NW][NT][4];
#pragma unroll
  for (int m = 0; m < NW; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
    }
  }
  const int nk = kdim / FL_BK;
#pragma unroll
  for (int s = 0; s < FL_STAGES - 1; ++s) {
    if (s < nk) load(s, s * FL_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FL_STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; stage kt-1 is free again
    const int next = kt + FL_STAGES - 1;
    if (next < nk) load(next % FL_STAGES, next * FL_BK);
    cp_async_commit();
    const unsigned st = ring_s + (kt % FL_STAGES) * STAGE_ELEMS * 2;
#pragma unroll
    for (int kk = 0; kk < FL_BK; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, st + a_lane + kk * 2);
#pragma unroll
      for (int m = 0; m < NW; ++m) {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          unsigned b[4];
          ldsm_x4_trans(b, st + (A_ELEMS + m * W_ELEMS + kk * W_LD + n * 8) * 2 + b_lane);
          mma_bf16(acc[m][n], a, b[0], b[1]);
          mma_bf16(acc[m][n + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the next tile may load

  // Accumulator e of tile n: row wr + lane/4 (+8 for e >= 2), column
  // wc + 8n + 2*(lane%4) + e%2.
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + wr + lane / 4 + (e / 2) * 8;
      const int j = col0 + wc + n * 8 + 2 * (lane % 4) + e % 2;
      if (row < rows) {
        const float y0 = acc[0][n][e] + (b0 ? b0[j] : 0.0f);
        if constexpr (NW == 1) {
          epi(row, j, y0);
        } else {
          epi(row, j, y0, acc[1][n][e] + b1[j]);
        }
      }
    }
  }
}

// Every tile of one product (rows x n columns, BN wide), row tile major.
// Products that share a stage number their tiles on from `first`, and
// block g takes the stage's tiles g, g + grid, ...  Returns first + tiles.
template <int NW, int BN, class ARow, class Epi>
__device__ int mm_stage(const ARow& arow, int rows, int kdim, int n,
                        const bf16* W0, const bf16* W1, int ldw, const float* b0,
                        const float* b1, const Epi& epi, int first = 0) {
  const int ntn = n / BN, tiles = (rows + FL_BM - 1) / FL_BM * ntn;
  const int g = gridDim.x;
  for (int t = ((int)blockIdx.x - first % g + g) % g; t < tiles; t += g) {
    mm_tile<NW, BN>(arow, rows, kdim, t / ntn, (t % ntn) * BN, W0, W1, ldw, b0, b1, epi);
  }
  return first + tiles;
}

// Epilogues: each output element is written by exactly one thread, and
// none reads global memory.
struct GateToHid {  // FF up: hid = bf16(silu(lin1) * linv)
  bf16* hid;
  int f;
  __device__ void operator()(int r, int j, float a, float v) const {
    hid[(size_t)r * f + j] = __float2bfloat16_rn(siluf(a) * v);
  }
};

struct StoreF32 {
  float* out;
  int d;
  __device__ void operator()(int r, int j, float y) const { out[(size_t)r * d + j] = y; }
};

struct StoreBF16 {
  bf16* out;
  int d;
  __device__ void operator()(int r, int j, float y) const {
    out[(size_t)r * d + j] = __float2bfloat16_rn(y);
  }
};

struct KvStore {  // k in fp32 (normed later), v in bf16
  float* kf;
  bf16* v;
  int d;
  __device__ void operator()(int r, int j, float k, float val) const {
    kf[(size_t)r * d + j] = k;
    v[(size_t)r * d + j] = __float2bfloat16_rn(val);
  }
};

struct ConvGlu {  // pw1: GLU a * sigmoid(gate), rounded to bf16
  bf16* out;
  int d;
  __device__ void operator()(int r, int j, float a, float g) const {
    out[(size_t)r * d + j] = __float2bfloat16_rn(a * sigmoidf(g));
  }
};

// ---------------------------------------------------------------------------
// Row stages: one warp per row of the (M, D) residual, grid-stride.
// ---------------------------------------------------------------------------

// The sub-block that ends here: with parts == 0 the residual starts as
// float(x); else y = (part[0] + ... + part[parts-1]) + bias, summed in that
// order, and res = bf16(res) + bf16(scale * y).  Then
// dst[r] = bf16(w * res[r] / (sqrt(sum res[r]^2) / sqrt(d) + 1e-8)); with a
// window the row also goes to the new window's last T rows.  A lane holds
// groups of 4 columns, and issues all its loads before it uses them.
__device__ void row_stage(const Params& P, int parts, const float* __restrict__ bias,
                          float scale, const float* __restrict__ w, bf16* dst, bf16* win_dst) {
  constexpr int GROUPS = FL_MAX_D / 128;  // 4-column groups per lane
  const int T = P.p.t, D = P.p.d, W = P.p.window, rows = P.batch * T;
  const size_t plane = (size_t)rows * D;
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * WARPS;
  const float sqrt_d = sqrtf((float)D);
  for (int r = blockIdx.x * WARPS + threadIdx.x / 32; r < rows; r += warps) {
    float4 v[GROUPS];
    float* res = P.res + (size_t)r * D;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int c = 4 * (lane + 32 * g);
      v[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c >= D) continue;
      if (parts == 0) {
        const uint2 raw = *reinterpret_cast<const uint2*>(P.x + (size_t)r * D + c);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        v[g] = make_float4(__low2float(x2[0]), __high2float(x2[0]), __low2float(x2[1]),
                           __high2float(x2[1]));
      } else {
        const float* y = P.part + (size_t)r * D + c;
        float4 sum = __ldcg(reinterpret_cast<const float4*>(y));
#pragma unroll
        for (int q = 1; q < FL_FF_SPLIT; ++q) {
          if (q < parts) {
            const float4 u = __ldcg(reinterpret_cast<const float4*>(y + q * plane));
            sum.x += u.x;
            sum.y += u.y;
            sum.z += u.z;
            sum.w += u.w;
          }
        }
        const float4 old = __ldcg(reinterpret_cast<const float4*>(res + c));
        const float4 b = *reinterpret_cast<const float4*>(bias + c);
        v[g] = make_float4(rbf(old.x) + rbf(scale * (sum.x + b.x)),
                           rbf(old.y) + rbf(scale * (sum.y + b.y)),
                           rbf(old.z) + rbf(scale * (sum.z + b.z)),
                           rbf(old.w) + rbf(scale * (sum.w + b.w)));
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      if (4 * (lane + 32 * g) < D) {
        *reinterpret_cast<float4*>(res + 4 * (lane + 32 * g)) = v[g];
        s += v[g].x * v[g].x + v[g].y * v[g].y + v[g].z * v[g].z + v[g].w * v[g].w;
      }
    }
    s = warp_sum(s);
    const float denom = sqrtf(s) / sqrt_d + 1e-8f;
    bf16* out = dst + (size_t)r * D;
    bf16* wout = win_dst ? win_dst + ((size_t)(r / T) * W + W - T + r % T) * D : nullptr;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int c = 4 * (lane + 32 * g);
      if (c >= D) continue;
      const float4 wc = *reinterpret_cast<const float4*>(w + c);
      __nv_bfloat162 o[2];
      o[0] = __floats2bfloat162_rn(wc.x * (v[g].x / denom), wc.y * (v[g].y / denom));
      o[1] = __floats2bfloat162_rn(wc.z * (v[g].z / denom), wc.w * (v[g].w / denom));
      *reinterpret_cast<uint2*>(out + c) = *reinterpret_cast<const uint2*>(o);
      if (wout) *reinterpret_cast<uint2*>(wout + c) = *reinterpret_cast<const uint2*>(o);
    }
  }
}

// New window rows 0 .. W-T-1: the old window's rows T .. W-1 (one warp per row).
__device__ void shift_window(const Params& P) {
  const int T = P.p.t, W = P.p.window, D = P.p.d, keep = W - T;
  const int lane = threadIdx.x % 32, warps = gridDim.x * WARPS;
  for (int r = blockIdx.x * WARPS + threadIdx.x / 32; r < P.batch * keep; r += warps) {
    const int b = r / keep, j = r % keep;
    const uint4* src = reinterpret_cast<const uint4*>(P.win_in + ((size_t)b * W + T + j) * D);
    uint4* dst = reinterpret_cast<uint4*>(P.win_out + ((size_t)b * W + j) * D);
    for (int c = lane; c < D / 8; c += 32) dst[c] = src[c];
  }
}

// ---------------------------------------------------------------------------
// Attention: one block per (stream, head), grid-stride.
// ---------------------------------------------------------------------------

// LayerNorm over the row's dh features, then RoPE on the first `rope` with
// table row `pos`; x is rounded to bf16 in place.  One warp.
__device__ void head_norm_rope(float* x, int dh, int rope, const float* scale, const float* bias,
                               const float* cos_t, const float* sin_t, int pos) {
  const int lane = threadIdx.x % 32, half = rope / 2;
  const bool in0 = lane < dh, in1 = lane + 32 < dh;
  const float x0 = in0 ? x[lane] : 0.0f, x1 = in1 ? x[lane + 32] : 0.0f;
  const float mean = warp_sum(x0 + x1) / (float)dh;
  const float d0 = in0 ? x0 - mean : 0.0f, d1 = in1 ? x1 - mean : 0.0f;
  const float var = warp_sum(d0 * d0 + d1 * d1) / (float)dh;
  const float inv = 1.0f / sqrtf(var + 1e-5f);
  if (in0) x[lane] = d0 * inv * scale[lane] + bias[lane];
  if (in1) x[lane + 32] = d1 * inv * scale[lane + 32] + bias[lane + 32];
  __syncwarp();
  float out[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = lane + 32 * u;
    out[u] = 0.0f;
    if (e < dh) {
      out[u] = x[e];
      if (e < rope) {
        const float partner = e < half ? -x[e + half] : x[e - half];
        out[u] = x[e] * cos_t[pos * rope + e] + partner * sin_t[pos * rope + e];
      }
    }
  }
  __syncwarp();
  if (in0) x[lane] = rbf(out[0]);
  if (in1) x[lane + 32] = rbf(out[1]);
  __syncwarp();
}

__device__ void attention_stage(const Params& P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FusedLayerArgs& p = P.p;
  const int T = p.t, W = p.window, D = p.d, H = p.n_heads, TKV = W + T, DH = D / H;
  const int KLD = DH + 1;  // neighbouring keys on distinct banks in the score loop
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* sq = reinterpret_cast<float*>(smem);  // (T, DH)
  float* sk = sq + T * DH;                     // (TKV, KLD)
  float* sv = sk + TKV * KLD;                  // (TKV, DH)
  float* ss = sv + TKV * DH;                   // (T, TKV)
  // The head norms' scales and biases and the RoPE tables, once per block.
  const int R = p.rope_dim;
  float* ln = ss + T * TKV;            // q scale, q bias, k scale, k bias (DH each)
  float* rope_q = ln + 4 * DH;         // cos, sin (T, R) each
  float* rope_k = rope_q + 2 * T * R;  // cos, sin (TKV, R) each
  if (p.recompute) {
    const float* vecs = P.vecs;
    const int src[4] = {p.qln_s, p.qln_b, p.kln_s, p.kln_b};
    for (int idx = tid; idx < 4 * DH; idx += FL_THREADS) {
      ln[idx] = vecs[src[idx / DH] + idx % DH];
    }
    for (int idx = tid; idx < T * R; idx += FL_THREADS) {
      rope_q[idx] = vecs[p.cos_q + idx];
      rope_q[T * R + idx] = vecs[p.sin_q + idx];
    }
    for (int idx = tid; idx < TKV * R; idx += FL_THREADS) {
      rope_k[idx] = vecs[p.cos_k + idx];
      rope_k[TKV * R + idx] = vecs[p.sin_k + idx];
    }
  }

  for (int item = blockIdx.x; item < P.batch * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const size_t sbase = (size_t)item * T * TKV;  // scores (B, H, T, TKV)
    // 16-byte loads: 8 bf16 of v, 4 floats of q and k
    const int vv = DH / 8, fv = DH / 4;
    stage_vectors<2>(
        TKV * vv,
        [&](int idx) {
          return __ldcg(reinterpret_cast<const uint4*>(
              P.v + ((size_t)b * TKV + idx / vv) * D + h * DH + (idx % vv) * 8));
        },
        [&](int idx, const uint4& raw) { unpack_bf16x8(raw, sv + idx * 8); });
    if (p.recompute) {
      stage_vectors<3>(
          (T + TKV) * fv,
          [&](int idx) {
            const int row = idx / fv;
            const float* src = row < T ? P.qf + ((size_t)b * T + row) * D
                                       : P.kf + ((size_t)b * TKV + row - T) * D;
            return __ldcg(reinterpret_cast<const uint4*>(src + h * DH + (idx % fv) * 4));
          },
          [&](int idx, const uint4& raw) {
            const int row = idx / fv, e = (idx % fv) * 4;
            float* dst = row < T ? sq + row * DH + e : sk + (row - T) * KLD + e;
            const float* f = reinterpret_cast<const float*>(&raw);
            dst[0] = f[0];
            dst[1] = f[1];
            dst[2] = f[2];
            dst[3] = f[3];
          });
    } else {
      for (int idx = tid; idx < T * TKV; idx += FL_THREADS) ss[idx] = P.scores_in[sbase + idx];
    }
    __syncthreads();

    if (p.recompute) {
      for (int row = warp; row < T + TKV; row += WARPS) {
        if (row < T) {
          head_norm_rope(sq + row * DH, DH, R, ln, ln + DH, rope_q, rope_q + T * R, row);
        } else {
          head_norm_rope(sk + (row - T) * KLD, DH, R, ln + 2 * DH, ln + 3 * DH, rope_k,
                         rope_k + TKV * R, row - T);
        }
      }
      __syncthreads();
      for (int idx = tid; idx < T * TKV; idx += FL_THREADS) {
        const int i = idx / TKV, c = idx % TKV;
        const float* qr = sq + i * DH;
        const float* kr = sk + c * KLD;
        float s = 0.0f;
        for (int e = 0; e < DH; ++e) s += qr[e] * kr[e];
        s *= P.inv_sqrt_dh;
        ss[idx] = s;
        P.scores_out[sbase + idx] = s;
      }
      __syncthreads();
    }

    const int n_inv = W ? P.invalid[b] : 0;
    for (int i = warp; i < T; i += WARPS) {
      float* s = ss + i * TKV;
      const int c0 = lane, c1 = lane + 32;
      const float s0 = c0 < TKV ? (c0 < n_inv ? -10000.0f : s[c0]) : -INFINITY;
      const float s1 = c1 < TKV ? (c1 < n_inv ? -10000.0f : s[c1]) : -INFINITY;
      const float m = warp_max(fmaxf(s0, s1));
      const float e0 = c0 < TKV ? expf(s0 - m) : 0.0f;
      const float e1 = c1 < TKV ? expf(s1 - m) : 0.0f;
      const float sum = warp_sum(e0 + e1);
      if (c0 < TKV) s[c0] = c0 < n_inv ? 0.0f : rbf(e0 / sum);
      if (c1 < TKV) s[c1] = c1 < n_inv ? 0.0f : rbf(e1 / sum);
    }
    __syncthreads();

    for (int idx = tid; idx < T * DH; idx += FL_THREADS) {
      const int i = idx / DH, e = idx % DH;
      const float* at = ss + i * TKV;
      float acc = 0.0f;
      for (int c = 0; c < TKV; ++c) acc += at[c] * sv[c * DH + e];
      P.act[((size_t)b * T + i) * D + h * DH + e] = __float2bfloat16_rn(acc);
    }
    __syncthreads();  // the next item overwrites the shared buffers
  }
}

// ---------------------------------------------------------------------------
// Depthwise conv: one block per (stream, FL_CONV_COLS channels), grid-stride.
// Padded row p of a stream is conv state row p (p < K-1) or GLU row p-K+1;
// the item's padded rows and taps are staged in shared memory first.
// ---------------------------------------------------------------------------

__device__ void conv_stage(const Params& P) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CC = FL_CONV_COLS;
  const FusedLayerArgs& p = P.p;
  const int T = p.t, D = p.d, K = p.conv_k, NP = K - 1 + T;
  const int ncb = (D + CC - 1) / CC;
  const bf16* dw = P.mats + p.dw;
  const float* vecs = P.vecs;
  float* pad = reinterpret_cast<float*>(smem);  // (NP, CC)
  float* taps = pad + NP * CC;                   // (K, CC)
  for (int item = blockIdx.x; item < P.batch * ncb; item += gridDim.x) {
    const int b = item / ncb, j0 = (item % ncb) * CC;
    // 16-byte loads of 8 channels: the padded rows, then the taps after them
    constexpr int CV = CC / 8;
    stage_vectors<5>(
        (NP + K) * CV,
        [&](int idx) {
          const int row = idx / CV, j = j0 + (idx % CV) * 8;
          if (j >= D) return make_uint4(0, 0, 0, 0);
          if (row < K - 1) {
            return *reinterpret_cast<const uint4*>(P.conv_in + ((size_t)b * (K - 1) + row) * D + j);
          }
          if (row < NP) {
            return __ldcg(reinterpret_cast<const uint4*>(
                P.hid + ((size_t)b * T + row - (K - 1)) * D + j));
          }
          return *reinterpret_cast<const uint4*>(dw + (size_t)(row - NP) * D + j);
        },
        [&](int idx, const uint4& raw) { unpack_bf16x8(raw, pad + idx * 8); });
    __syncthreads();
    for (int idx = threadIdx.x; idx < T * CC; idx += FL_THREADS) {
      const int t = idx / CC, c = idx % CC, j = j0 + c;
      if (j >= D) continue;
      float acc = 0.0f;
      for (int tap = 0; tap < K; ++tap) acc += pad[(t + tap) * CC + c] * taps[tap * CC + c];
      acc += vecs[p.dw_b + j];
      P.act[((size_t)b * T + t) * D + j] =
          __float2bfloat16_rn(siluf(acc * vecs[p.bn_scale + j] + vecs[p.bn_shift + j]));
    }
    for (int idx = threadIdx.x; idx < (K - 1) * CC; idx += FL_THREADS) {
      const int i = idx / CC, c = idx % CC, j = j0 + c;
      if (j < D) {
        P.conv_out[((size_t)b * (K - 1) + i) * D + j] = __float2bfloat16_rn(pad[(T + i) * CC + c]);
      }
    }
    __syncthreads();  // the next item overwrites the shared buffers
  }
}

// ---------------------------------------------------------------------------
// The layer.
// ---------------------------------------------------------------------------

// FF up (gate into hid), barrier, FF down in ff_split depth slices, each
// into its own plane of `part`; the next row stage adds them and the bias.
__device__ void feed_forward(const Params& P, cg::grid_group& grid, bool second) {
  const FusedLayerArgs& p = P.p;
  const int D = p.d, F = p.f, M = P.batch * p.t, KS = F / P.ff_split;
  const bf16* mats = P.mats;
  const float* vecs = P.vecs;
  mm_stage<2, FL_BN_FF>(RowsOf{P.act, D}, M, D, F, mats + (second ? p.ff2_w1 : p.ff1_w1),
                        mats + (second ? p.ff2_wv : p.ff1_wv), F,
                        vecs + (second ? p.ff2_b1 : p.ff1_b1),
                        vecs + (second ? p.ff2_bv : p.ff1_bv), GateToHid{P.hid, F});
  grid.sync();
  stage_mark(second ? 13 : 2);
  const bf16* w2 = mats + (second ? p.ff2_w2 : p.ff1_w2);
  int first = 0;
  for (int s = 0; s < P.ff_split; ++s) {
    first = mm_stage<1, FL_BN_FF>(RowsOf{P.hid + s * KS, F}, M, KS, D,
                                  w2 + (size_t)s * KS * D, w2, D, nullptr, nullptr,
                                  StoreF32{P.part + (size_t)s * M * D, D}, first);
  }
}

__global__ void __launch_bounds__(FL_THREADS, FL_MAX_BLOCKS_PER_SM)
fused_layer_kernel(const Params P) {
  cg::grid_group grid = cg::this_grid();
  const FusedLayerArgs& p = P.p;
  const int T = p.t, W = p.window, D = p.d, M = P.batch * T, MKV = P.batch * (W + T);
  const bf16* mats = P.mats;
  const float* vecs = P.vecs;
  stage_mark(0);

  // feed-forward 1
  row_stage(P, 0, nullptr, 0.0f, vecs + p.n_ff1, P.act, nullptr);
  grid.sync();
  stage_mark(1);
  feed_forward(P, grid, false);
  grid.sync();
  stage_mark(3);

  // rotary MHSA
  row_stage(P, P.ff_split, vecs + p.ff1_b2, 0.5f, vecs + p.n_att, P.act, W ? P.win_out : nullptr);
  if (W) shift_window(P);
  grid.sync();
  stage_mark(4);
  {
    const KvRows kv{P.win_in, P.act, T, W, D};
    if (p.recompute) {
      const int first = mm_stage<1, FL_BN>(RowsOf{P.act, D}, M, D, D, mats + p.wq, mats + p.wq,
                                           D, vecs + p.bq, vecs + p.bq, StoreF32{P.qf, D});
      mm_stage<2, FL_BN>(kv, MKV, D, D, mats + p.wk, mats + p.wv, D, vecs + p.bk, vecs + p.bv,
                         KvStore{P.kf, P.v, D}, first);
    } else {
      mm_stage<1, FL_BN>(kv, MKV, D, D, mats + p.wv, mats + p.wv, D, vecs + p.bv, vecs + p.bv,
                         StoreBF16{P.v, D});
    }
  }
  grid.sync();
  stage_mark(5);
  attention_stage(P);
  grid.sync();
  stage_mark(6);
  mm_stage<1, FL_BN>(RowsOf{P.act, D}, M, D, D, mats + p.wout, mats + p.wout, D, nullptr,
                     nullptr, StoreF32{P.part, D});
  grid.sync();
  stage_mark(7);

  // conv module
  row_stage(P, 1, vecs + p.bout, 1.0f, vecs + p.n_conv, P.act, nullptr);
  grid.sync();
  stage_mark(8);
  mm_stage<2, FL_BN>(RowsOf{P.act, D}, M, D, D, mats + p.pw1, mats + p.pw1 + D, 2 * D,
                     vecs + p.pw1_b, vecs + p.pw1_b + D, ConvGlu{P.hid, D});
  grid.sync();
  stage_mark(9);
  conv_stage(P);
  grid.sync();
  stage_mark(10);
  mm_stage<1, FL_BN>(RowsOf{P.act, D}, M, D, D, mats + p.pw2, mats + p.pw2, D, nullptr,
                     nullptr, StoreF32{P.part, D});
  grid.sync();
  stage_mark(11);

  // feed-forward 2, output norm
  row_stage(P, 1, vecs + p.pw2_b, 1.0f, vecs + p.n_ff2, P.act, nullptr);
  grid.sync();
  stage_mark(12);
  feed_forward(P, grid, true);
  grid.sync();
  stage_mark(14);
  row_stage(P, P.ff_split, vecs + p.ff2_b2, 0.5f, vecs + p.n_out, P.y, nullptr);
  stage_mark(15);
}

constexpr int MAX_DEVICES = 64;
bool attributes_set[MAX_DEVICES];

// Raises the kernel's dynamic shared-memory limit on the current device,
// once per device.
cudaError_t set_attributes(int* device) {
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attributes_set[*device]) {
    err = cudaFuncSetAttribute(fused_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FL_SMEM);
    if (err != cudaSuccess) return err;
    attributes_set[*device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// The card's capacity for this kernel on the current device: resident
// blocks per SM (occupancy at FL_THREADS threads and FL_SMEM bytes) and the
// SM count.  Fails if the device cannot launch cooperatively.
extern "C" int tone_fused_layer_occupancy(int* blocks_per_sm, int* sm_count) {
  int dev = 0, coop = 0;
  cudaError_t err = set_attributes(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fused_layer_kernel,
                                                        FL_THREADS, FL_SMEM);
  }
  return (int)err;
}

// Launches the layer as one cooperative kernel of `grid` blocks on `stream`
// and returns the launch's cudaError_t (0 = success).  Does not synchronise
// and allocates nothing: `scratch` holds s.total bytes laid out as `s`, and
// FF down runs in `ff_split` depth slices (F a multiple of ff_split * FL_BK).
// `win`, `win_out` and `invalid` are read only when window > 0, `scores_in`
// only when recompute == 0, `scores_out` only when recompute != 0.
extern "C" int tone_fused_layer(const void* x, const void* conv_in, const void* win_in,
                                const void* invalid, const void* scores_in, const void* mats,
                                const void* vecs, FusedLayerArgs p, int batch, void* y,
                                void* conv_out, void* win_out, void* scores_out, void* scratch,
                                FusedLayerScratch s, int ff_split, int grid, void* stream) {
  const int tkv = p.window + p.t, dh = p.n_heads > 0 ? p.d / p.n_heads : 0;
  const size_t attn_smem =
      (size_t)(p.t * dh + tkv * (dh + 1) + tkv * dh + p.t * tkv + 4 * dh + 2 * tkv * p.rope_dim +
               2 * p.t * p.rope_dim) * 4;
  const size_t conv_smem = (size_t)(2 * p.conv_k - 1 + p.t) * FL_CONV_COLS * 4;
  if (batch <= 0 || grid <= 0 || p.t <= 0 || p.d <= 0 || p.n_heads <= 0 ||
      p.d % p.n_heads != 0 || p.d % FL_BK != 0 || p.d % FL_BN_FF != 0 || p.d > FL_MAX_D ||
      p.f % FL_BN_FF != 0 || ff_split < 1 || ff_split > FL_FF_SPLIT ||
      p.f % (ff_split * FL_BK) != 0 || p.conv_k < 1 || p.window < 0 ||
      (p.window > 0 && p.window < p.t) || tkv > FL_MAX_TKV || dh > FL_MAX_DH ||
      p.rope_dim % 2 != 0 || p.rope_dim > dh || dh % 8 != 0 || attn_smem > (size_t)FL_SMEM ||
      conv_smem > (size_t)FL_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  const long long offs[] = {s.res, s.act, s.hid, s.qf, s.kf, s.v, s.part};
  for (long long o : offs) {
    if (o < 0 || o % FL_SCRATCH_ALIGN != 0 || o > s.total) return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = set_attributes(&dev);
  if (err != cudaSuccess) return (int)err;

  unsigned char* base = static_cast<unsigned char*>(scratch);
  Params P;
  P.x = static_cast<const bf16*>(x);
  P.conv_in = static_cast<const bf16*>(conv_in);
  P.win_in = static_cast<const bf16*>(win_in);
  P.invalid = static_cast<const int*>(invalid);
  P.scores_in = static_cast<const float*>(scores_in);
  P.mats = static_cast<const bf16*>(mats);
  P.vecs = static_cast<const float*>(vecs);
  P.y = static_cast<bf16*>(y);
  P.conv_out = static_cast<bf16*>(conv_out);
  P.win_out = static_cast<bf16*>(win_out);
  P.scores_out = static_cast<float*>(scores_out);
  P.res = reinterpret_cast<float*>(base + s.res);
  P.act = reinterpret_cast<bf16*>(base + s.act);
  P.hid = reinterpret_cast<bf16*>(base + s.hid);
  P.qf = reinterpret_cast<float*>(base + s.qf);
  P.kf = reinterpret_cast<float*>(base + s.kf);
  P.v = reinterpret_cast<bf16*>(base + s.v);
  P.part = reinterpret_cast<float*>(base + s.part);
  P.p = p;
  P.batch = batch;
  P.ff_split = ff_split;
  P.inv_sqrt_dh = (float)(1.0 / sqrt((double)dh));
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)fused_layer_kernel, dim3(grid),
                                    dim3(FL_THREADS), args, FL_SMEM, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef FL_STAGE_CLOCK
// The global timer (ns) block 0 read at the start, after each barrier and
// at the end of the last launch: 16 values.
extern "C" int tone_fused_layer_stage_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, stage_ns, 16 * sizeof(unsigned long long));
}
#endif
