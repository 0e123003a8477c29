// One whole Macaron Conformer layer of the streaming step, for Hopper.
//
// Replaces the Pallas TPU kernel tone_tpu/ops/fused_layer.py
// `fused_conformer_layer` (pallas_call :445, body `_make_kernel` :216-375):
// FF1 -> rotary MHSA (score reuse, sliding window, invalid-prefix mask) ->
// GLU + causal depthwise conv + folded BatchNorm -> FF2 -> output RMSNorm,
// for one stream per thread block, with every intermediate in shared memory.
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
// Shapes (row-major, one stream per block): x, y (B, T, D) bf16; conv state
// in/out (B, K-1, D) bf16; window in/out (B, W, D) bf16; invalid (B,) int32;
// scores in/out (B, H, T, W+T) fp32.  Weights: `mats` (bf16) and `vecs`
// (fp32) packed by flatten_layer_params, offsets in FusedLayerArgs.  On
// the main path D = 384, H = 8 (d_head 48), F = 1536, K = 31, T = 10 and
// W in {0, 30}, or T = 5 and W in {0, 15} in the reduced layers: 16
// launches per step.
//
// Bound on an H100 SXM (3.35 TB/s, 989 dense bf16 TFLOP/s): a full-rate
// recompute layer at B = 64 reads 9.2 MB of weights and about 3 MB of
// activations and state, and does about 5.9 GFLOP, so it is bound by
// operations at about 6 us (at B = 16 by bytes, at about 3 us).
//
// Design (simple and right first; tensor cores, cp.async/TMA and several
// streams per block are later work): one block of 256 threads per stream.
// The residual (T x D fp32) and one arena that the stages reuse live in
// dynamic shared memory (about 146 KB at full width, in the MHSA stage).
// Matmuls: each thread owns output columns j, j + 256, ...; for each k it
// loads W[k][j] once (coalesced across the warp) and updates up to MR row
// accumulators from activation rows in shared memory (16-byte broadcast
// reads), so each weight element is read once per block per MR rows; the
// loads of the next 8 rows of W start before the current 8 are used.  The FF gate and
// the (T, F) hidden activation never leave shared memory.  Norms use one
// warp per row (shuffles); the softmax one warp per (head, query row).
// Keys are stored with a row stride of D + 2 so that the score loop, whose
// neighbouring threads read neighbouring keys, hits distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
}

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MR = 16;       // activation rows per pass of a matmul
constexpr int KU = 8;        // weight rows per step of a matmul (16-byte activation reads)
constexpr int MAX_TKV = 64;  // softmax: two keys per lane
constexpr int MAX_DH = 64;   // head LayerNorm: two features per lane
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline size_t al16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float b2f(bf16 v) { return __bfloat162float(v); }
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

// Shared-memory sizes of the stages (bytes); the kernel carves the same.
struct Sizes {
  size_t res, ff, mhsa, conv, total;
};

__host__ __device__ inline Sizes stage_sizes(const FusedLayerArgs& p) {
  const size_t T = p.t, D = p.d, F = p.f, H = p.n_heads, K = p.conv_k;
  const size_t TKV = p.window + p.t;
  Sizes s;
  s.res = al16(T * D * 4);
  s.ff = al16(T * D * 2) + al16(T * F * 2);
  const size_t tail = al16(TKV * D * 2) + al16(H * T * TKV * 4) + al16(T * D * 2);
  s.mhsa = al16(TKV * D * 2) + tail;
  if (p.recompute) {
    const size_t tmp = TKV * D * 4 > tail ? al16(TKV * D * 4) : tail;
    s.mhsa = al16(TKV * D * 2) + al16(T * D * 2) + al16(TKV * (D + 2) * 2) + tmp;
  }
  s.conv = al16(T * D * 2) + al16((K - 1 + T) * D * 2) + al16(T * D * 2);
  size_t arena = s.ff > s.mhsa ? s.ff : s.mhsa;
  arena = arena > s.conv ? arena : s.conv;
  s.total = s.res + arena;
  return s;
}

// NW products sharing A: out_m(r, j) = sum_k A[r][k] W_m[k][j] + b_m[j] for
// r < rows, j < n, handed to epi(r, j, out_0) or epi(r, j, out_0, out_1).
// A: bf16 rows in shared memory (stride lda, a multiple of KU); W_m: bf16
// (kdim x n, row stride ldw) in global memory; kdim a multiple of KU.  The
// weights of the next KU rows are loaded while the current ones are used,
// so each thread keeps NW * KU loads in flight.
template <int NW, class Epi>
__device__ void matmul_n(const bf16* A, int lda, int rows, int kdim, const bf16* __restrict__ W0,
                         const bf16* __restrict__ W1, int ldw, int n,
                         const float* __restrict__ b0, const float* __restrict__ b1, Epi epi) {
  const bf16* const Ws[2] = {W0, W1};
  for (int r0 = 0; r0 < rows; r0 += MR) {
    const int nr = min(MR, rows - r0);
    const bf16* a0 = A + (size_t)r0 * lda;
    for (int j = threadIdx.x; j < n; j += THREADS) {
      float acc[NW][MR];
      float wc[NW][KU], wn[NW][KU];
#pragma unroll
      for (int m = 0; m < NW; ++m) {
#pragma unroll
        for (int r = 0; r < MR; ++r) acc[m][r] = 0.0f;
#pragma unroll
        for (int u = 0; u < KU; ++u) wc[m][u] = b2f(__ldg(Ws[m] + (size_t)u * ldw + j));
      }
      for (int k = 0; k < kdim; k += KU) {
        if (k + KU < kdim) {
#pragma unroll
          for (int m = 0; m < NW; ++m) {
#pragma unroll
            for (int u = 0; u < KU; ++u) {
              wn[m][u] = b2f(__ldg(Ws[m] + (size_t)(k + KU + u) * ldw + j));
            }
          }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r < nr) {
            const uint4 raw = *reinterpret_cast<const uint4*>(a0 + (size_t)r * lda + k);
            const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int u = 0; u < KU / 2; ++u) {
              const float lo = __low2float(a2[u]), hi = __high2float(a2[u]);
#pragma unroll
              for (int m = 0; m < NW; ++m) {
                acc[m][r] += lo * wc[m][2 * u];
                acc[m][r] += hi * wc[m][2 * u + 1];
              }
            }
          }
        }
#pragma unroll
        for (int m = 0; m < NW; ++m) {
#pragma unroll
          for (int u = 0; u < KU; ++u) wc[m][u] = wn[m][u];
        }
      }
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < nr) {
          if constexpr (NW == 1) {
            epi(r0 + r, j, acc[0][r] + b0[j]);
          } else {
            epi(r0 + r, j, acc[0][r] + b0[j], acc[1][r] + b1[j]);
          }
        }
      }
    }
  }
}

template <class Epi>
__device__ void matmul(const bf16* A, int lda, int rows, int kdim, const bf16* __restrict__ W,
                       int ldw, int n, const float* __restrict__ bias, Epi epi) {
  matmul_n<1>(A, lda, rows, kdim, W, W, ldw, n, bias, bias, epi);
}

// Two products sharing A, for gated units.
template <class Epi>
__device__ void matmul2(const bf16* A, int lda, int rows, int kdim, const bf16* __restrict__ W1,
                        const bf16* __restrict__ W2, int ldw, int n,
                        const float* __restrict__ b1, const float* __restrict__ b2, Epi epi) {
  matmul_n<2>(A, lda, rows, kdim, W1, W2, ldw, n, b1, b2, epi);
}

// dst[r][:] = bf16(w * src[r] / (sqrt(sum src[r]^2) / sqrt(d) + 1e-8)); one
// warp per row.
__device__ void rms_rows(const float* src, int rows, int d, const float* __restrict__ w,
                         bf16* dst) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float sqrt_d = sqrtf((float)d);
  for (int r = warp; r < rows; r += WARPS) {
    const float* x = src + (size_t)r * d;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += x[c] * x[c];
    s = warp_sum(s);
    const float denom = sqrtf(s) / sqrt_d + 1e-8f;
    for (int c = lane; c < d; c += 32) {
      dst[(size_t)r * d + c] = __float2bfloat16_rn(w[c] * (x[c] / denom));
    }
  }
}

// Per (row, head) of src (rows x D fp32): LayerNorm over the head's dh
// features, then RoPE on the first `rope` of them with the row's tables;
// written as bf16 to dst (row stride ldd).  One warp per (row, head).
__device__ void head_norm_rope(float* src, int rows, int D, int H, int rope,
                               const float* __restrict__ scale, const float* __restrict__ bias,
                               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                               bf16* dst, int ldd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dh = D / H, half = rope / 2;
  for (int item = warp; item < rows * H; item += WARPS) {
    const int r = item / H, h = item % H;
    float* x = src + (size_t)r * D + h * dh;
    const bool in0 = lane < dh, in1 = lane + 32 < dh;
    const float x0 = in0 ? x[lane] : 0.0f, x1 = in1 ? x[lane + 32] : 0.0f;
    const float mean = warp_sum(x0 + x1) / (float)dh;
    const float d0 = in0 ? x0 - mean : 0.0f, d1 = in1 ? x1 - mean : 0.0f;
    const float var = warp_sum(d0 * d0 + d1 * d1) / (float)dh;
    const float inv = 1.0f / sqrtf(var + 1e-5f);
    if (in0) x[lane] = d0 * inv * scale[lane] + bias[lane];
    if (in1) x[lane + 32] = d1 * inv * scale[lane + 32] + bias[lane + 32];
    __syncwarp();
    for (int e = lane; e < dh; e += 32) {
      float out = x[e];
      if (e < rope) {
        const float partner = e < half ? -x[e + half] : x[e - half];
        out = x[e] * cos_t[r * rope + e] + partner * sin_t[r * rope + e];
      }
      dst[(size_t)r * ldd + h * dh + e] = __float2bfloat16_rn(out);
    }
    __syncwarp();
  }
}

// res = bf16(res) + bf16(scale * y), the residual update of every sub-block.
struct ResidualAdd {
  float* res;
  int d;
  float scale;
  __device__ void operator()(int r, int j, float y) const {
    float* o = res + (size_t)r * d + j;
    *o = rbf(*o) + rbf(scale * y);
  }
};

__device__ void feed_forward(float* res, unsigned char* arena, const FusedLayerArgs& p,
                             const bf16* mats, const float* vecs, bool second) {
  const int T = p.t, D = p.d, F = p.f;
  bf16* h = reinterpret_cast<bf16*>(arena);
  bf16* g = reinterpret_cast<bf16*>(arena + al16((size_t)T * D * 2));
  rms_rows(res, T, D, vecs + (second ? p.n_ff2 : p.n_ff1), h);
  __syncthreads();
  matmul2(h, D, T, D, mats + (second ? p.ff2_w1 : p.ff1_w1),
          mats + (second ? p.ff2_wv : p.ff1_wv), F, F, vecs + (second ? p.ff2_b1 : p.ff1_b1),
          vecs + (second ? p.ff2_bv : p.ff1_bv), [&](int r, int j, float a, float v) {
            g[(size_t)r * F + j] = __float2bfloat16_rn(siluf(a) * v);
          });
  __syncthreads();
  matmul(g, F, T, F, mats + (second ? p.ff2_w2 : p.ff1_w2), D, D,
         vecs + (second ? p.ff2_b2 : p.ff1_b2), ResidualAdd{res, D, 0.5f});
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
fused_layer_kernel(const bf16* __restrict__ x, const bf16* __restrict__ conv_in,
                   const bf16* __restrict__ win_in, const int* __restrict__ invalid,
                   const float* __restrict__ scores_in, const bf16* __restrict__ mats,
                   const float* __restrict__ vecs, FusedLayerArgs p, float inv_sqrt_dh,
                   bf16* __restrict__ y_out, bf16* __restrict__ conv_out,
                   bf16* __restrict__ win_out, float* __restrict__ scores_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t b = blockIdx.x;
  const int T = p.t, W = p.window, D = p.d, H = p.n_heads, K = p.conv_k;
  const int TKV = W + T, DH = D / H, KLD = D + 2;
  const Sizes sz = stage_sizes(p);
  float* res = reinterpret_cast<float*>(smem);
  unsigned char* arena = smem + sz.res;

  for (int i = tid; i < T * D; i += THREADS) res[i] = b2f(x[b * T * D + i]);
  __syncthreads();

  // ---- feed-forward 1 ----
  feed_forward(res, arena, p, mats, vecs, false);

  // ---- rotary MHSA ----
  {
    unsigned char* ptr = arena;
    bf16* kv = reinterpret_cast<bf16*>(ptr);  // [window ‖ normalised chunk]
    ptr += al16((size_t)TKV * D * 2);
    bf16* q = nullptr;
    bf16* k = nullptr;
    if (p.recompute) {
      q = reinterpret_cast<bf16*>(ptr);
      ptr += al16((size_t)T * D * 2);
      k = reinterpret_cast<bf16*>(ptr);
      ptr += al16((size_t)TKV * KLD * 2);
    }
    float* tmp = reinterpret_cast<float*>(ptr);  // q, k before their norms
    bf16* v = reinterpret_cast<bf16*>(ptr);      // reuses tmp after k
    ptr += al16((size_t)TKV * D * 2);
    float* sc = reinterpret_cast<float*>(ptr);
    ptr += al16((size_t)H * T * TKV * 4);
    bf16* ctx = reinterpret_cast<bf16*>(ptr);

    bf16* a = kv + (size_t)W * D;
    rms_rows(res, T, D, vecs + p.n_att, a);
    for (int i = tid; i < W * D; i += THREADS) kv[i] = win_in[b * W * D + i];
    __syncthreads();
    for (int i = tid; i < W * D; i += THREADS) win_out[b * W * D + i] = kv[(size_t)T * D + i];

    if (p.recompute) {
      auto to_tmp = [&](int r, int j, float val) { tmp[(size_t)r * D + j] = val; };
      matmul(a, D, T, D, mats + p.wq, D, D, vecs + p.bq, to_tmp);
      __syncthreads();
      head_norm_rope(tmp, T, D, H, p.rope_dim, vecs + p.qln_s, vecs + p.qln_b,
                     vecs + p.cos_q, vecs + p.sin_q, q, D);
      __syncthreads();
      matmul(kv, D, TKV, D, mats + p.wk, D, D, vecs + p.bk, to_tmp);
      __syncthreads();
      head_norm_rope(tmp, TKV, D, H, p.rope_dim, vecs + p.kln_s, vecs + p.kln_b,
                     vecs + p.cos_k, vecs + p.sin_k, k, KLD);
      __syncthreads();
      for (int idx = tid; idx < H * T * TKV; idx += THREADS) {
        const int c = idx % TKV, i = (idx / TKV) % T, h = idx / (TKV * T);
        const bf16* qr = q + (size_t)i * D + h * DH;
        const bf16* kr = k + (size_t)c * KLD + h * DH;
        float s = 0.0f;
        for (int e = 0; e < DH; ++e) s += b2f(qr[e]) * b2f(kr[e]);
        s *= inv_sqrt_dh;
        sc[idx] = s;
        scores_out[b * H * T * TKV + idx] = s;
      }
    } else {
      for (int idx = tid; idx < H * T * TKV; idx += THREADS) {
        sc[idx] = scores_in[b * H * T * TKV + idx];
      }
    }
    matmul(kv, D, TKV, D, mats + p.wv, D, D, vecs + p.bv,
           [&](int r, int j, float val) { v[(size_t)r * D + j] = __float2bfloat16_rn(val); });
    __syncthreads();

    const int n_inv = W ? invalid[b] : 0;
    for (int row = warp; row < H * T; row += WARPS) {
      float* s = sc + (size_t)row * TKV;
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

    for (int idx = tid; idx < T * D; idx += THREADS) {
      const int i = idx / D, col = idx % D, h = col / DH;
      const float* at = sc + (size_t)(h * T + i) * TKV;
      float acc = 0.0f;
      for (int c = 0; c < TKV; ++c) acc += at[c] * b2f(v[(size_t)c * D + col]);
      ctx[idx] = __float2bfloat16_rn(acc);
    }
    __syncthreads();
    matmul(ctx, D, T, D, mats + p.wout, D, D, vecs + p.bout, ResidualAdd{res, D, 1.0f});
    __syncthreads();
  }

  // ---- conv module ----
  {
    bf16* cn = reinterpret_cast<bf16*>(arena);
    bf16* padded = reinterpret_cast<bf16*>(arena + al16((size_t)T * D * 2));
    bf16* yc = reinterpret_cast<bf16*>(arena + al16((size_t)T * D * 2) +
                                       al16((size_t)(K - 1 + T) * D * 2));
    rms_rows(res, T, D, vecs + p.n_conv, cn);
    for (int i = tid; i < (K - 1) * D; i += THREADS) padded[i] = conv_in[b * (K - 1) * D + i];
    __syncthreads();
    bf16* gl = padded + (size_t)(K - 1) * D;
    matmul2(cn, D, T, D, mats + p.pw1, mats + p.pw1 + D, 2 * D, D, vecs + p.pw1_b,
            vecs + p.pw1_b + D, [&](int r, int j, float a, float g) {
              gl[(size_t)r * D + j] = __float2bfloat16_rn(a * sigmoidf(g));
            });
    __syncthreads();
    for (int i = tid; i < (K - 1) * D; i += THREADS) {
      conv_out[b * (K - 1) * D + i] = padded[(size_t)T * D + i];
    }
    const bf16* dw = mats + p.dw;
    for (int idx = tid; idx < T * D; idx += THREADS) {
      const int r = idx / D, j = idx % D;
      float acc = 0.0f;
      for (int tap = 0; tap < K; ++tap) {
        acc += b2f(padded[(size_t)(r + tap) * D + j]) * b2f(dw[(size_t)tap * D + j]);
      }
      acc += vecs[p.dw_b + j];
      yc[idx] = __float2bfloat16_rn(siluf(acc * vecs[p.bn_scale + j] + vecs[p.bn_shift + j]));
    }
    __syncthreads();
    matmul(yc, D, T, D, mats + p.pw2, D, D, vecs + p.pw2_b, ResidualAdd{res, D, 1.0f});
    __syncthreads();
  }

  // ---- feed-forward 2, output norm ----
  feed_forward(res, arena, p, mats, vecs, true);
  rms_rows(res, T, D, vecs + p.n_out, y_out + b * T * D);
}

}  // namespace

// Launches one block per stream on `stream`; returns the launch's
// cudaError_t (0 = success).  Does not synchronise and allocates nothing.
// `win`, `win_out` and `invalid` are read only when window > 0, `scores_in`
// only when recompute == 0, `scores_out` only when recompute != 0.
extern "C" int tone_fused_layer(const void* x, const void* conv_in, const void* win_in,
                                const void* invalid, const void* scores_in, const void* mats,
                                const void* vecs, FusedLayerArgs p, int batch, void* y,
                                void* conv_out, void* win_out, void* scores_out,
                                void* stream) {
  const int tkv = p.window + p.t;
  if (batch <= 0 || p.t <= 0 || p.d <= 0 || p.n_heads <= 0 || p.d % p.n_heads != 0 ||
      p.d % KU != 0 || p.f % KU != 0 || p.conv_k < 1 || p.window < 0 ||
      (p.window > 0 && p.window < p.t) || tkv > MAX_TKV || p.d / p.n_heads > MAX_DH ||
      p.rope_dim % 2 != 0 || p.rope_dim > p.d / p.n_heads) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = stage_sizes(p).total;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float inv_sqrt_dh = (float)(1.0 / sqrt((double)(p.d / p.n_heads)));
  fused_layer_kernel<<<batch, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(conv_in),
      static_cast<const bf16*>(win_in), static_cast<const int*>(invalid),
      static_cast<const float*>(scores_in), static_cast<const bf16*>(mats),
      static_cast<const float*>(vecs), p, inv_sqrt_dh, static_cast<bf16*>(y),
      static_cast<bf16*>(conv_out), static_cast<bf16*>(win_out),
      static_cast<float*>(scores_out));
  return (int)cudaGetLastError();
}
