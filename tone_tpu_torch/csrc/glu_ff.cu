// Fused GLU gate -> output projection of the Conformer feed-forward, for Hopper.
//
//   y = bf16( (bf16(silu_fp32(a)) * v) @ W2 + b ),   av = [a | v]
//
// Replaces the Pallas TPU kernel tone_tpu/ops/glu_ff.py `_glu_ff2_2d` (body
// `_kernel`, :43-48) with the same numerics: the sigmoid in fp32, the gate
// rounded to bf16, the product with v in bf16, the matmul on bf16 operands
// summed in fp32, the fp32 bias added before the one rounding to bf16.
//
// Shapes: av (M, 2F) bf16 row-major, W2 (F, D) bf16 row-major, b (D,) fp32,
// y (M, D) bf16.  On the serving path F = 1536, D = 384, M = 10 * B (5 * B
// in the temporally reduced layers 7-14); it runs twice per layer, 32 times
// per step.
//
// Bound on an H100 SXM (3.35 TB/s, 989 dense bf16 TFLOP/s): at B = 256,
// M = 2560, the kernel must read av (15.7 MB) and W2 (1.2 MB) and write y
// (2.0 MB), about 18.9 MB, which takes 5.6 us; its 2*M*F*D = 3.0 GFLOP take
// 3.1 us.  So it is memory-bound, and av dominates the bytes.  What the
// design does about it: the gated product g (M, F) — as large as half of av
// — never goes to device memory.  Each block builds its slice of g in shared
// memory straight from av and feeds it to the tensor cores, so the traffic
// is read(av) + read(W2) + write(y) instead of adding write(g) + read(g).
//
// Design (simple and correct first; wgmma, TMA and pipelining come later):
// one block of 4 warps computes a BM x BN tile of y.  It loops over F in
// BK-wide slices; for each slice it builds the BM x BK gate tile and copies
// the BK x BN slice of W2 into shared memory, then each warp runs WMMA
// bf16 16x16x16 products (fp32 accumulators) on its 16-column strip.  Rows
// past M read zeros and are not stored.  The host entry checks that F is a
// multiple of BK and D a multiple of BN; the Python wrapper checks dtypes,
// contiguity and 16-byte alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 32;            // rows of av / y per block
constexpr int BN = 64;            // columns of y per block
constexpr int BK = 32;            // slice of F per iteration
constexpr int WARPS = 4;          // one 16-column strip of the tile each
constexpr int THREADS = WARPS * 32;
constexpr int G_LD = BK + 8;      // padded shared-memory leading dimensions
constexpr int W_LD = BN + 8;
constexpr int C_LD = BN + 4;

static_assert(BN == WARPS * 16, "each warp owns one 16-column strip");
static_assert(BM == 32, "each warp holds two 16-row accumulators");
static_assert(BM * BK == THREADS * 8, "one 8-element gate vector per thread");
static_assert((BK * BN / 8) % THREADS == 0, "W2 slice splits evenly");

__global__ void __launch_bounds__(THREADS)
glu_ff2_kernel(const __nv_bfloat16* __restrict__ av,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ y,
               int m, int f, int d) {
  __shared__ __align__(32) __nv_bfloat16 g_s[BM * G_LD];
  __shared__ __align__(32) __nv_bfloat16 w_s[BK * W_LD];
  __shared__ __align__(32) float c_s[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  // This thread's 8 gate elements of each slice: one row, 8 columns.
  const int g_row = tid / (BK / 8);
  const int g_col = (tid % (BK / 8)) * 8;
  const bool row_ok = m0 + g_row < m;
  const __nv_bfloat16* a_ptr = av + (size_t)(m0 + g_row) * (2 * f) + g_col;
  const __nv_bfloat16* v_ptr = a_ptr + f;

  for (int k0 = 0; k0 < f; k0 += BK) {
    uint4 a_raw = make_uint4(0, 0, 0, 0);
    uint4 v_raw = make_uint4(0, 0, 0, 0);
    if (row_ok) {
      a_raw = *reinterpret_cast<const uint4*>(a_ptr + k0);
      v_raw = *reinterpret_cast<const uint4*>(v_ptr + k0);
    }
    const __nv_bfloat16* a8 = reinterpret_cast<const __nv_bfloat16*>(&a_raw);
    const __nv_bfloat16* v8 = reinterpret_cast<const __nv_bfloat16*>(&v_raw);
    uint4 g_raw;
    __nv_bfloat16* g8 = reinterpret_cast<__nv_bfloat16*>(&g_raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = __bfloat162float(a8[j]);
      const __nv_bfloat16 s = __float2bfloat16(a * (1.0f / (1.0f + expf(-a))));
      g8[j] = __float2bfloat16(__bfloat162float(s) * __bfloat162float(v8[j]));
    }
    *reinterpret_cast<uint4*>(&g_s[g_row * G_LD + g_col]) = g_raw;

#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / 8);
      const int c = (idx % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&w_s[r * W_LD + c]) =
          *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * d + n0 + c);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa0, fa1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa0, g_s + kk, G_LD);
      wmma::load_matrix_sync(fa1, g_s + 16 * G_LD + kk, G_LD);
      wmma::load_matrix_sync(fb, w_s + kk * W_LD + warp * 16, W_LD);
      wmma::mma_sync(acc[0], fa0, fb, acc[0]);
      wmma::mma_sync(acc[1], fa1, fb, acc[1]);
    }
    __syncthreads();
  }

  wmma::store_matrix_sync(c_s + warp * 16, acc[0], C_LD, wmma::mem_row_major);
  wmma::store_matrix_sync(c_s + 16 * C_LD + warp * 16, acc[1], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx % BN;
    if (m0 + r < m) {
      y[(size_t)(m0 + r) * d + n0 + c] = __float2bfloat16(c_s[r * C_LD + c] + bias[n0 + c]);
    }
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
// Does not synchronise and allocates nothing.
extern "C" int tone_glu_ff2(const void* av, const void* w, const void* b, void* y,
                            int m, int f, int d, void* stream) {
  if (m <= 0 || f <= 0 || d <= 0 || f % BK != 0 || d % BN != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((m + BM - 1) / BM, d / BN);
  glu_ff2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(av), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), m, f, d);
  return (int)cudaGetLastError();
}

extern "C" int tone_glu_ff2_tile_f() { return BK; }
extern "C" int tone_glu_ff2_tile_d() { return BN; }
