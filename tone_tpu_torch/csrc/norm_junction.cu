// The FastConformer's residual-and-norm junction between sublayers, for
// Hopper: the sublayer's last bias, its residual scale and add, and the
// LayerNorm that feeds the next sublayer, in one pass over the stream.
//
//   r  = bf16(y + b)                  y: the sublayer's float32 product, no bias
//   s  = bf16(r * scale)              0.5 after a feed-forward, 1 elsewhere
//   x' = bf16(x + s)                  x: the bf16 residual stream
//   n  = bf16(LN(x') * gamma + beta)  LN in float32: mean, mean of squared
//                                     deviations, rsqrt(var + eps)
//
// It replaces no TPU kernel: the JAX package has no FastConformer.  It
// replaces the port's chain of eager passes around each LayerNorm of
// core/fastconformer.py `_layer` (the bias pass of the sublayer's last
// `linear`, the feed-forwards' * 0.5, the residual add, and `layernorm`'s
// eleven float32 passes: the widening, two means, two subtractions, the
// square, rsqrt, the scale, the shift and the rounding), which together
// moved about 99 bytes per element of d_model per junction.
//
// Forms (`form`, one launch each):
//   0 norm only:  a = LN1(x)                         (the first layer's norm_ff1)
//   1 single:     a = x', b = LN1(x')                (after FF1, attention, conv)
//   2 double:     a = LN1(x'), b = LN2(bf16(a))      (after FF2: norm_out, then
//                                                     the next layer's norm_ff1)
//   3 last:       a = LN1(x')                        (the last layer's norm_out)
// Every rounding is today's path's: each product and sum rounded to float32
// on its own (no fused multiply-add), then to bf16 where the eager path
// stores bf16, so x' is bit-equal to it; the LayerNorms differ from it only
// in the order of their two float32 sums.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Per element of d_model: y read
// (4), x read (2) and two bf16 outputs written (4): 10 bytes for the
// single and double forms, 8 for the last, 4 for norm only.  The design
// moves each byte once:
//
//   * One warp per row (a frame of a call) of d_model elements, held in
//     registers: a lane holds NJ_CHUNKS vectors of 8 elements, vector
//     lane + 32 c of the row.  Loads and stores are 16 bytes a lane (one
//     bf16 vector, or half of a float32 vector), neighbouring lanes on
//     neighbouring addresses.  The bias, gamma and beta vectors are the
//     same for every row and stay in L1.
//   * The two reductions of each LayerNorm are butterfly shuffles in the
//     warp: no shared memory, no barrier.
//   * Every row of the padded batch is computed, as the eager path does.
//     Frames at or past y's frames (the attention's output covers the
//     longest call only) add nothing: x' = bf16(x + 0).
//
// The vectors a lane holds are a template parameter: 1, 2, 4 or 8 (d_model
// up to 2,048, a multiple of 8); any other d_model is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ops/norm_junction.py reads these lines: keep one `constexpr int NAME =
// value;` per line.
constexpr int NJ_VEC = 8;          // elements of a 16-byte bf16 vector
constexpr int NJ_MAX_CHUNKS = 8;   // vectors a lane holds at most
constexpr int NJ_WARPS = 8;        // rows (warps) of a block

namespace {

typedef __nv_bfloat16 bf16;

enum Form { NORM_ONLY = 0, SINGLE = 1, DOUBLE = 2, LAST = 3 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ void load_bf16x8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_f32x8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Stores 8 values that are already bf16 values held in float (exact).
__device__ __forceinline__ void store_bf16x8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// LayerNorm of the row in v (float32, lanes' vectors below `vecs`), each
// result rounded to bf16 and kept in v as float.
template <int CHUNKS>
__device__ __forceinline__ void layer_norm(float (&v)[CHUNKS][NJ_VEC], const float* gamma,
                                           const float* beta, int lane, int vecs, int d,
                                           float eps) {
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
    if (lane + 32 * c < vecs)
#pragma unroll
      for (int e = 0; e < NJ_VEC; ++e) sum = __fadd_rn(sum, v[c][e]);
  const float mean = __fdiv_rn(warp_sum(sum), (float)d);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
    if (lane + 32 * c < vecs)
#pragma unroll
      for (int e = 0; e < NJ_VEC; ++e) {
        const float dev = __fsub_rn(v[c][e], mean);
        sq = __fadd_rn(sq, __fmul_rn(dev, dev));
      }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)d), eps));
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int k = lane + 32 * c;
    if (k < vecs) {
      float g[NJ_VEC], b[NJ_VEC];
      load_f32x8(gamma + k * NJ_VEC, g);
      load_f32x8(beta + k * NJ_VEC, b);
#pragma unroll
      for (int e = 0; e < NJ_VEC; ++e)
        v[c][e] = round_bf16(
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c][e], mean), rstd), g[e]), b[e]));
    }
  }
}

template <int CHUNKS>
__device__ __forceinline__ void store_row(bf16* out, const float (&v)[CHUNKS][NJ_VEC], int lane,
                                          int vecs) {
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int k = lane + 32 * c;
    if (k < vecs) store_bf16x8(out + k * NJ_VEC, v[c]);
  }
}

template <int CHUNKS, int FORM>
__global__ void __launch_bounds__(NJ_WARPS * 32)
norm_junction_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                     const bf16* __restrict__ x, const float* __restrict__ gamma1,
                     const float* __restrict__ beta1, const float* __restrict__ gamma2,
                     const float* __restrict__ beta2, bf16* __restrict__ out_a,
                     bf16* __restrict__ out_b, float scale, float eps, int rows, int frames,
                     int y_frames, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * NJ_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int vecs = d / NJ_VEC;
  const int64_t at = row * d;
  float v[CHUNKS][NJ_VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int k = lane + 32 * c;
    if (k < vecs) load_bf16x8(x + at + k * NJ_VEC, v[c]);
  }
  if (FORM != NORM_ONLY) {
    const int t = (int)(row % frames);
    const int64_t y_at = (row / frames * y_frames + t) * d;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int k = lane + 32 * c;
      if (k >= vecs) continue;
      float s[NJ_VEC];
      if (t < y_frames) {
        float yv[NJ_VEC], bv[NJ_VEC];
        load_f32x8(y + y_at + k * NJ_VEC, yv);
        load_f32x8(bias + k * NJ_VEC, bv);
#pragma unroll
        for (int e = 0; e < NJ_VEC; ++e)
          s[e] = round_bf16(__fmul_rn(round_bf16(__fadd_rn(yv[e], bv[e])), scale));
      } else {
#pragma unroll
        for (int e = 0; e < NJ_VEC; ++e) s[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < NJ_VEC; ++e) v[c][e] = round_bf16(__fadd_rn(v[c][e], s[e]));
    }
  }
  if (FORM == SINGLE) store_row<CHUNKS>(out_a + at, v, lane, vecs);
  layer_norm<CHUNKS>(v, gamma1, beta1, lane, vecs, d, eps);
  if (FORM == SINGLE) {
    store_row<CHUNKS>(out_b + at, v, lane, vecs);
  } else {
    store_row<CHUNKS>(out_a + at, v, lane, vecs);
  }
  if (FORM == DOUBLE) {
    layer_norm<CHUNKS>(v, gamma2, beta2, lane, vecs, d, eps);
    store_row<CHUNKS>(out_b + at, v, lane, vecs);
  }
}

template <int CHUNKS, int FORM>
cudaError_t launch(const void* y, const void* bias, const void* x, const void* gamma1,
                   const void* beta1, const void* gamma2, const void* beta2, void* out_a,
                   void* out_b, float scale, float eps, int rows, int frames, int y_frames,
                   int d, cudaStream_t stream) {
  const int blocks = (rows + NJ_WARPS - 1) / NJ_WARPS;
  norm_junction_kernel<CHUNKS, FORM><<<blocks, NJ_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(bias),
      static_cast<const bf16*>(x), static_cast<const float*>(gamma1),
      static_cast<const float*>(beta1), static_cast<const float*>(gamma2),
      static_cast<const float*>(beta2), static_cast<bf16*>(out_a), static_cast<bf16*>(out_b),
      scale, eps, rows, frames, y_frames, d);
  return cudaGetLastError();
}

template <int CHUNKS>
cudaError_t launch_form(int form, const void* y, const void* bias, const void* x,
                        const void* gamma1, const void* beta1, const void* gamma2,
                        const void* beta2, void* out_a, void* out_b, float scale, float eps,
                        int rows, int frames, int y_frames, int d, cudaStream_t stream) {
  switch (form) {
    case NORM_ONLY:
      return launch<CHUNKS, NORM_ONLY>(y, bias, x, gamma1, beta1, gamma2, beta2, out_a, out_b,
                                       scale, eps, rows, frames, y_frames, d, stream);
    case SINGLE:
      return launch<CHUNKS, SINGLE>(y, bias, x, gamma1, beta1, gamma2, beta2, out_a, out_b,
                                    scale, eps, rows, frames, y_frames, d, stream);
    case DOUBLE:
      return launch<CHUNKS, DOUBLE>(y, bias, x, gamma1, beta1, gamma2, beta2, out_a, out_b,
                                    scale, eps, rows, frames, y_frames, d, stream);
    case LAST:
      return launch<CHUNKS, LAST>(y, bias, x, gamma1, beta1, gamma2, beta2, out_a, out_b,
                                  scale, eps, rows, frames, y_frames, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// rows = B * frames rows of d elements; y (B, y_frames, d) float32 with
// y_frames <= frames (unused by form 0); outputs (B, frames, d) bf16.
extern "C" int tone_norm_junction(const void* y, const void* bias, const void* x,
                                  const void* gamma1, const void* beta1, const void* gamma2,
                                  const void* beta2, void* out_a, void* out_b, float scale,
                                  float eps, int rows, int frames, int y_frames, int d,
                                  int form, void* stream) {
  if (rows <= 0 || frames <= 0 || y_frames < 0 || y_frames > frames || d <= 0 ||
      d % NJ_VEC != 0 || d > 32 * NJ_VEC * NJ_MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (d / NJ_VEC + 31) / 32;
  if (chunks <= 1)
    return (int)launch_form<1>(form, y, bias, x, gamma1, beta1, gamma2, beta2, out_a, out_b,
                               scale, eps, rows, frames, y_frames, d, s);
  if (chunks <= 2)
    return (int)launch_form<2>(form, y, bias, x, gamma1, beta1, gamma2, beta2, out_a, out_b,
                               scale, eps, rows, frames, y_frames, d, s);
  if (chunks <= 4)
    return (int)launch_form<4>(form, y, bias, x, gamma1, beta1, gamma2, beta2, out_a, out_b,
                               scale, eps, rows, frames, y_frames, d, s);
  return (int)launch_form<NJ_MAX_CHUNKS>(form, y, bias, x, gamma1, beta1, gamma2, beta2, out_a,
                                         out_b, scale, eps, rows, frames, y_frames, d, s);
}
