// Fused GLU gate -> output projection of the Conformer feed-forward, for Hopper.
//
//   y = bf16( (bf16(bf16(silu_fp32(a)) * v)) @ W2 + b ),   av = [a | v]
//
// Replaces the Pallas TPU kernel tone_tpu/ops/glu_ff.py `_glu_ff2_2d` (body
// `_kernel`, :43-48) with the same numerics: the sigmoid in fp32, the gate
// rounded to bf16, the product with v in bf16, the matmul on bf16 operands
// summed in fp32, the fp32 bias added after the last partial, one rounding
// to bf16.  The gated product never reaches device memory.
//
// Shapes: av (M, 2F) bf16 row-major, W2 (F, D) bf16 row-major, b (D,) fp32,
// y (M, D) bf16.  On the serving path F = 1536, D = 384, M = 10 * B (5 * B
// in the temporally reduced layers 7-14); it runs twice per layer, 32 times
// per step: M = 80 and 160 at 16 slots, 320 and 640 at B = 64, 2560 at
// B = 256.
//
// Bound on an H100 SXM (3.35 TB/s, 989 dense bf16 TFLOP/s): bytes, at every
// production M.  The kernel must read av (M * 6 KB) and W2 (1.2 MB) and
// write y; at M = 640 that is 5.6 MB (1.67 us) against 0.755 GFLOP (0.76 us
// at the bf16 rate), at M = 160 2.2 MB (0.68 us).  So what it needs is
// bytes in flight on every SM and short serial chains, not a faster
// product.  The design:
//
//   * Fill the card at every M.  At M <= 160 there are only 9-15 output
//     tiles, so F is cut in `split` depth slices (grid = tiles x split, a
//     power of two up to 8, planned from the SM count by ops/glu_ff.py
//     `plan_glu_ff`).  A tile's slices run as one thread-block cluster:
//     each block leaves its fp32 partial tile in its shared memory, and
//     after a cluster barrier each block reduces 1/split of the tile,
//     reading every slice's partial through distributed shared memory and
//     adding them in slice order 0 .. split-1 before the bias and the one
//     rounding.  No atomics and no scratch in device memory; no sum depends
//     on timing, so two launches agree bit for bit.  One launch.
//   * Loads in flight.  A block's av rows (a and v of one BK-deep slice of
//     F) and W2 rows come into shared memory through a cp.async ring of
//     STAGES slots (16-byte vectors, L1 bypassed): STAGES - 1 stages are
//     issued before the first is used, and in the loop stage kt+1 is gated
//     and stage kt multiplied while the next ones load.  Rows past M and
//     columns past D are zero-filled (source size 0) and never stored.
//   * Tensor cores through ldmatrix + mma.sync m16n8k16 on shared-space
//     addresses, fp32 accumulators.  The bf16 gate is built in place over
//     the staged a tile (each thread gates the vectors it reads), one stage
//     ahead of the product, so one barrier per stage separates them.  The
//     sigmoid uses the SFU's 2^x and 1/x (the precise expf and IEEE divide
//     made the gate the longest part of each stage).
//   * The epilogue goes through shared memory only (the partial tiles);
//     nothing but y is written to device memory.
//
// Two tiles (csrc/glu_ff_plan.cuh): 32 x 128 with BK = 64 and 4 warps below
// GF_BIG_MIN_ROWS rows, 64 x 128 with BK = 32 and 8 warps from there; a
// warp owns 32 rows x 32 columns in both.  Each av row is read once per
// column tile (3 at D = 384), each W2 column once per row tile.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "glu_ff_plan.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

template <int BM_, int BN_, int BK_, int WN_, int MT_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WN = WN_, MT = MT_, STAGES = STAGES_;
  static constexpr int WARPS = BM / (16 * MT) * WN;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int A_LD = 2 * BK + 8;  // a row of the stage: [a | v | pad]
  static constexpr int W_LD = BN + 8;
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * W_LD;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * 2;  // dynamic shared memory (bytes)
  // resident blocks per SM that shared memory allows (1 KB reserved per
  // block), capped where registers would fall below 128 per thread
  static constexpr int SMEM_BLOCKS = 232448 / (SMEM + 1024);
  static constexpr int MIN_BLOCKS = SMEM_BLOCKS < 512 / THREADS ? SMEM_BLOCKS : 512 / THREADS;
  static constexpr int NT = BN / WN / 8;  // 8-column accumulator tiles per warp
  // 16-byte vectors a thread copies per stage (a and v; W2) and gates
  static constexpr int A_CP = BM * 2 * BK / 8 / THREADS;
  static constexpr int W_CP = BK * BN / 8 / THREADS;
  static constexpr int G_CP = BM * BK / 8 / THREADS;
  static_assert(BM % (16 * MT) == 0 && NT % 2 == 0 && BK % 16 == 0, "mma tile shapes");
  static_assert(A_CP * THREADS * 8 == BM * 2 * BK, "a and v tiles split evenly");
  static_assert(W_CP * THREADS * 8 == BK * BN, "W2 tile splits evenly");
  static_assert(G_CP * THREADS * 8 == BM * BK, "gate tile splits evenly");
  static constexpr int RED_LD = BN + 4;  // a row of the fp32 partial tile (reduction)
  static_assert(STAGES >= 3 && SMEM_BLOCKS >= 1, "a ring of at least 3 stages fits");
  static_assert(BM * RED_LD * 4 <= SMEM, "the partial tile fits in the ring");
};

using Small = Tile<GF_SMALL_BM, GF_SMALL_BN, GF_SMALL_BK, GF_SMALL_WN, GF_SMALL_MT, GF_SMALL_STAGES>;
using Big = Tile<GF_BIG_BM, GF_BIG_BN, GF_BIG_BK, GF_BIG_WN, GF_BIG_MT, GF_BIG_STAGES>;

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

// silu(a) = a * sigmoid(a) in fp32: 2^x and 1/x by the SFU (approximate
// to about 2 ulp of fp32, well below the bf16 rounding that follows).
__device__ __forceinline__ float silu(float a) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(a * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return a * r;
}

// bf16(bf16(silu(a)) * v) for 8 elements, in place of a: the product of
// two bf16 is rounded once, as bf16(float(s) * float(v)).
__device__ __forceinline__ void gate8(bf16* a_row, const bf16* v_row) {
  uint4 a_raw = *reinterpret_cast<const uint4*>(a_row);
  const uint4 v_raw = *reinterpret_cast<const uint4*>(v_row);
  __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(&a_raw);
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v_raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 a = __bfloat1622float2(a2[j]);
    a2[j] = __hmul2(__floats2bfloat162_rn(silu(a.x), silu(a.y)), v2[j]);
  }
  *reinterpret_cast<uint4*>(a_row) = a_raw;
}

// Block (tile, slice): tile = row tile * ceil(d / BN) + column tile, slice =
// blockIdx.y of gridDim.y depth slices of f / gridDim.y each.
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
glu_ff2_kernel(const bf16* __restrict__ av, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ y, int m, int f, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, ntn = (d + T::BN - 1) / T::BN;
  const int row0 = (tile / ntn) * T::BM, col0 = (tile % ntn) * T::BN;
  const int split = gridDim.y, slice = blockIdx.y;  // a cluster holds the tile's slices
  const int k_begin = slice * (f / split), nk = f / split / T::BK;

  // A thread copies the same rows and columns at every depth step: a row
  // of the stage is a's BK columns, then v's (f columns further in av).
  const bf16* a_src[T::A_CP];
  int a_dst[T::A_CP];
  bool a_ok[T::A_CP];
#pragma unroll
  for (int i = 0; i < T::A_CP; ++i) {
    const int idx = tid + i * T::THREADS;
    const int r = idx / (T::BK / 4), c = (idx % (T::BK / 4)) * 8;
    a_ok[i] = row0 + r < m;
    a_src[i] = av + (size_t)(a_ok[i] ? row0 + r : 0) * 2 * f + (c < T::BK ? c : f + c - T::BK) +
               k_begin;  // ragged rows: zero-filled
    a_dst[i] = r * T::A_LD + c;
  }
  const bf16* w_src[T::W_CP];
  int w_dst[T::W_CP];
  bool w_ok[T::W_CP];
#pragma unroll
  for (int i = 0; i < T::W_CP; ++i) {
    const int idx = tid + i * T::THREADS;
    const int r = idx / (T::BN / 8), c = (idx % (T::BN / 8)) * 8;
    w_ok[i] = col0 + c < d;
    w_src[i] = w + (size_t)(k_begin + r) * d + col0 + (w_ok[i] ? c : 0);  // ragged columns: zeros
    w_dst[i] = T::A_ELEMS + r * T::W_LD + c;
  }
  auto load = [&](int slot, int kt) {
    bf16* st = ring + slot * T::STAGE_ELEMS;
    const int k0 = kt * T::BK;
#pragma unroll
    for (int i = 0; i < T::A_CP; ++i) cp_async16(st + a_dst[i], a_src[i] + k0, a_ok[i]);
#pragma unroll
    for (int i = 0; i < T::W_CP; ++i) {
      cp_async16(st + w_dst[i], w_src[i] + (size_t)k0 * d, w_ok[i]);
    }
  };

  // mma.sync fragments by ldmatrix: the gate as stored, W2 transposed.
  const int wr = (warp / T::WN) * 16 * T::MT, wc = (warp % T::WN) * (T::BN / T::WN);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned a_lane = ((wr + lane % 16) * T::A_LD + (lane / 16) * 8) * 2;
  const unsigned b_lane =
      ((lane % 8 + ((lane / 8) % 2) * 8) * T::W_LD + wc + (lane / 16) * 8) * 2;
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int n = 0; n < T::NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    }
  }

  // Stage kt is gated in iteration kt - 1 and multiplied in iteration kt:
  // one barrier per stage, and a warp's gate math for the next stage
  // interleaves with its tensor-core work on this one.
  auto gate = [&](int kt) {
    bf16* st = ring + (kt % T::STAGES) * T::STAGE_ELEMS;
#pragma unroll
    for (int i = 0; i < T::G_CP; ++i) {
      const int idx = tid + i * T::THREADS;
      const int r = idx / (T::BK / 8), c = (idx % (T::BK / 8)) * 8;
      gate8(st + r * T::A_LD + c, st + r * T::A_LD + T::BK + c);
    }
  };
  auto multiply = [&](int kt) {
    const unsigned st_s = ring_s + (kt % T::STAGES) * T::STAGE_ELEMS * 2;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 16) {
      unsigned a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) ldsm_x4(a[i], st_s + a_lane + (16 * i * T::A_LD + kk) * 2);
#pragma unroll
      for (int n = 0; n < T::NT; n += 2) {
        unsigned b[4];
        ldsm_x4_trans(b, st_s + (T::A_ELEMS + kk * T::W_LD + n * 8) * 2 + b_lane);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_bf16(acc[i][n], a[i], b[0], b[1]);
          mma_bf16(acc[i][n + 1], a[i], b[2], b[3]);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<T::STAGES - 2>();  // stage 0 has landed (this thread's copies)
  __syncthreads();                 // ... everyone's
  gate(0);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<T::STAGES - 3>();  // stage kt+1 has landed (this thread's copies)
    __syncthreads();  // ... everyone's; gate kt is in place; stage kt-1 is free again
    const int next = kt + T::STAGES - 1;
    if (next < nk) load(next % T::STAGES, next);
    cp_async_commit();
    if (kt + 1 < nk) gate(kt + 1);
    multiply(kt);
  }
  cp_async_wait<0>();

  // The tile's `split` slices are one cluster (of one block when split is
  // 1): each block puts its fp32 partial in its own shared memory, then
  // reduces 1/split of the tile, reading the partials of all slices
  // (distributed shared memory) and adding them in slice order.
  // Accumulators e = 2h, 2h+1 of tile (i, n) are row wr + 16i + lane/4 + 8h,
  // columns wc + 8n + 2*(lane%4) and the next one.
  cg::cluster_group cluster = cg::this_cluster();
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int n = 0; n < T::NT; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(red + (wr + 16 * i + lane / 4 + 8 * h) * T::RED_LD + wc +
                                   n * 8 + 2 * (lane % 4)) =
            make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
      }
    }
  }
  cluster.sync();  // every slice's partial is in place
  const float* peer[GF_MAX_SPLIT];
#pragma unroll
  for (int q = 0; q < GF_MAX_SPLIT; ++q) {
    if (q < split) peer[q] = cluster.map_shared_rank(red, q);
  }
  constexpr int VECS = T::BM * T::BN / 4;  // float4 vectors of the tile
  for (int v = (int)cluster.block_rank() * T::THREADS + tid; v < VECS; v += split * T::THREADS) {
    const int r = v / (T::BN / 4), c = (v % (T::BN / 4)) * 4;
    if (row0 + r >= m || col0 + c >= d) continue;
    float4 p[GF_MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < GF_MAX_SPLIT; ++q) {  // every load in flight before the first add
      if (q < split) p[q] = *reinterpret_cast<const float4*>(peer[q] + r * T::RED_LD + c);
    }
    float4 sum = p[0];
#pragma unroll
    for (int q = 1; q < GF_MAX_SPLIT; ++q) {
      if (q < split) {
        sum.x += p[q].x;
        sum.y += p[q].y;
        sum.z += p[q].z;
        sum.w += p[q].w;
      }
    }
    const float4 b = *reinterpret_cast<const float4*>(bias + col0 + c);
    __nv_bfloat162 out[2] = {__floats2bfloat162_rn(sum.x + b.x, sum.y + b.y),
                             __floats2bfloat162_rn(sum.z + b.z, sum.w + b.w)};
    *reinterpret_cast<uint2*>(y + (size_t)(row0 + r) * d + col0 + c) =
        *reinterpret_cast<const uint2*>(out);
  }
  cluster.sync();  // a block's shared memory outlives its peers' reads
}

constexpr int MAX_DEVICES = 64;

// Launches one tile's kernel as clusters of `split` blocks (a tile's
// slices); raises its dynamic shared-memory limit on the current device
// first, once per device.
template <class T>
cudaError_t launch(const void* av, const void* w, const void* b, void* y, int m, int f, int d,
                   int split, cudaStream_t stream) {
  static bool attributes_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (f % (split * T::BK) != 0) return cudaErrorInvalidValue;
  if (!attributes_set[dev]) {
    err = cudaFuncSetAttribute(glu_ff2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
    if (err != cudaSuccess) return err;
    attributes_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + T::BM - 1) / T::BM * ((d + T::BN - 1) / T::BN), split);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, glu_ff2_kernel<T>, static_cast<const bf16*>(av),
                           static_cast<const bf16*>(w), static_cast<const float*>(b),
                           static_cast<bf16*>(y), m, f, d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` with tile `big` (0: GF_SMALL_*, 1: GF_BIG_*) and F
// cut in `split` depth slices (one cluster per output tile), and returns
// the launch's cudaError_t (0 = success).  Does not synchronise and
// allocates nothing.
extern "C" int tone_glu_ff2(const void* av, const void* w, const void* b, void* y, int m, int f,
                            int d, int big, int split, void* stream) {
  if (m <= 0 || f <= 0 || d <= 0 || d % 8 != 0 || split < 1 || split > GF_MAX_SPLIT ||
      (big != 0 && big != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(big ? launch<Big>(av, w, b, y, m, f, d, split, s)
                   : launch<Small>(av, w, b, y, m, f, d, split, s));
}
