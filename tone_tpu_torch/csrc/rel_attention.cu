// Relative-position self-attention of the FastConformer (Transformer-XL's,
// NeMo's RelPositionMultiHeadAttention) over whole calls, for Hopper.
//
//   S[i][j] = (q_i + u)/sqrt(dh) . k_j  +  (q_i + v)/sqrt(dh) . p_{i-j}
//   ctx_i   = sum_j bf16(softmax_j(S[i][.] with keys j >= len masked)) v_j
//
// It replaces no TPU kernel: the JAX package has no FastConformer and no
// Pallas attention of this kind.  It replaces the port's chain of library
// calls for one layer's attention (core/layers.py `rel_attention_plain`:
// two score products, the relative shift as a strided add, the key mask,
// a float32 softmax, the bf16 weights' product with V), whose float32
// (rows, H, queries, keys) scores went through device memory five times.
//
// Bound on an H100 SXM (989 dense bf16 TFLOP/s, 3.35 TB/s): operations.  A
// row of T frames takes 6 T^2 d useful operations per layer (2 T^2 d for
// the content scores, 2 T^2 d for the position scores, one d_head dot per
// pair and head, 2 T^2 d for the weights times V) against about 10 T d
// bytes of q, k, v, the positions and the output.  (NeMo's product of each
// query with all 2T - 1 positions would add 2 T^2 d; the shift in the tile
// below runs (BN + 16) / BN of one product instead.)  The design keeps
// every score on chip:
//
//   * One block per (row, head, tile of RA_BM queries), the grid built on
//     the host (ops/rel_attention.py `plan_rel_attention`): only the query
//     tiles below the row's own length, longest rows first.  A block walks
//     the key tiles of RA_BN keys below its row's length, and no further;
//     keys at or past the length (in the last tile) get -inf before the
//     softmax.  4 warps, each owning 16 query rows.
//   * q + u and q + v are made in registers from the bf16 q tile, in
//     float32, divided by sqrt(dh) and rounded once to bf16 (the rounding
//     the plain version makes); k, v and the positions' rows are the
//     projections' bf16 outputs, read in place from (B, T, H * dh) and
//     (2T - 1, H * dh).
//   * The relative shift in the tile: a warp's 16 queries i0..i0+15 against
//     keys j0..j0+BN-1 need the BN + 15 position rows i0 - j0 - BN + 1 ..
//     i0 + 15 - j0, contiguous in the positions' layout (position r at row
//     T - 1 - r).  The warp multiplies its q + v by that window of BN + 16
//     rows, stages the float32 product in its own shared memory and reads
//     back the diagonal raw[i][(15 - i) + j] as it adds it to the content
//     scores.  The position rows come through a ring of BM + BN rows in
//     shared memory: each key tile brings only its BN new rows.
//   * Products on the tensor cores by ldmatrix + mma.sync m16n8k16 (bf16
//     operands, float32 accumulators); k, v and the position rows come
//     into shared memory by cp.async (16-byte vectors, L1 bypassed), each
//     issued as soon as the tile it replaces has been read, so that it
//     lands under the other products.
//   * Online softmax in float32 (a running max and sum per query row); the
//     weights are rounded to bf16 before their product with V; the output
//     accumulates in float32, is divided by the row's sum once, rounded to
//     bf16 and stored straight into (B, T, H * dh), the layout the output
//     projection reads.  Output rows at or past a row's length are left as
//     the wrapper allocated them (zeros).
//
// d_head is a template parameter: 32, 64 or 128; any other is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// The tile sizes (ops/rel_attention.py reads them from these lines: keep
// one `constexpr int NAME = value;` per line).
constexpr int RA_BM = 64;       // queries of a block: 4 warps of 16
constexpr int RA_BN = 64;       // keys of a tile

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = RA_BM / 16;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Shape {
  static constexpr int BM = RA_BM, BN = RA_BN;
  static constexpr int LD = DH + 8;          // bf16 per shared row (16-byte pad: ldmatrix
                                             // rows fall in distinct banks)
  static constexpr int RING = BM + BN;       // position rows held: one key tile's window
  static constexpr int WIN = BN + 16;        // a warp's window (BN + 15 rows used)
  static constexpr int SLD = WIN + 8;        // float32 per staging row
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + BN * LD * 2;
  static constexpr int P_OFF = V_OFF + BN * LD * 2;
  static constexpr int S_OFF = P_OFF + RING * LD * 2;
  static constexpr int STAGE_BYTES = WARPS * 16 * SLD * 4;
  static constexpr int Q_BYTES = BM * LD * 2;  // the q tile, staged once in the same place
  static constexpr int SMEM = S_OFF + (STAGE_BYTES > Q_BYTES ? STAGE_BYTES : Q_BYTES);
  static constexpr int KT = DH / 16;         // 16-deep steps over d_head
  static constexpr int NT = BN / 8;          // 8-key score tiles
  static constexpr int OT = DH / 8;          // 8-column output tiles
  static constexpr int CH = DH / 8;          // 16-byte vectors of a row
  static_assert((RING & (RING - 1)) == 0, "the position ring is a power of two");
  static_assert(BN % 16 == 0 && DH % 16 == 0 && BM == 16 * WARPS, "mma tile shapes");
  static_assert(BN * CH % THREADS == 0 && BM * CH % THREADS == 0, "tiles split evenly");
  static_assert(S_OFF % 16 == 0 && V_OFF % 16 == 0 && P_OFF % 16 == 0, "aligned regions");
};

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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
// c += a (16x16, row) * b (16x8, col): bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// bf16((q + bias) / scale) for the two bf16 of `q2`, columns col, col + 1.
__device__ __forceinline__ unsigned biased(unsigned q2, const float* bias, int col, float scale) {
  const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q2));
  const float2 b = *reinterpret_cast<const float2*>(bias + col);
  return pack_bf16((q.x + b.x) / scale, (q.y + b.y) / scale);
}

// Block (item, head) = (blockIdx.x / n_heads, blockIdx.x % n_heads); item =
// (row, query tile, row length, unused).  q, k, v and out are (B, tq, H * DH)
// bf16, pe (2 tq - 1, H * DH) bf16 (position tq - 1 - r at row r), bias_u and
// bias_v (H, DH) float32.
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
rel_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ pe,
                     const float* __restrict__ bias_u, const float* __restrict__ bias_v,
                     const int4* __restrict__ items, bf16* __restrict__ out, int tq,
                     int n_heads, float scale) {
  using S = Shape<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int4 item = items[blockIdx.x / n_heads];
  const int head = blockIdx.x % n_heads;
  const int row = item.x, i0 = item.y * S::BM, len = item.z;
  const int d = n_heads * DH;
  const size_t base = (size_t)row * tq * d + (size_t)head * DH;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const bf16* pb = pe + (size_t)head * DH;
  const int n_pos = 2 * tq - 1;
  const unsigned smem_s = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned k_s = smem_s + S::K_OFF, v_s = smem_s + S::V_OFF, p_s = smem_s + S::P_OFF;
  const unsigned scratch_s = smem_s + S::S_OFF;

  // BN rows of k or v from row `first` into shared rows 0.., zero-filled
  // at and past `end`; position rows into the ring's slot row mod RING.
  auto load_tile = [&](unsigned dst, const bf16* src, int first, int end) {
#pragma unroll
    for (int i = 0; i < S::BN * S::CH / THREADS; ++i) {
      const int idx = tid + i * THREADS, r = idx / S::CH, c = (idx % S::CH) * 8;
      const bool ok = first + r < end;
      cp_async16(dst + (r * S::LD + c) * 2, src + (size_t)(ok ? first + r : 0) * d + c, ok);
    }
  };
  auto load_positions = [&](int first, int n_rows) {
    for (int idx = tid; idx < n_rows * S::CH; idx += THREADS) {
      const int r = first + idx / S::CH, c = (idx % S::CH) * 8;
      const bool ok = r >= 0 && r < n_pos;
      cp_async16(p_s + ((r & (S::RING - 1)) * S::LD + c) * 2,
                 pb + (size_t)(ok ? r : 0) * d + c, ok);
    }
  };

  // The block's position window of key tile kt starts at row
  // tq - BM - i0 + kt * BN and holds RING rows.
  const int n_kt = (len + S::BN - 1) / S::BN;
  const int p_first = tq - S::BM - i0;
#pragma unroll
  for (int i = 0; i < S::BM * S::CH / THREADS; ++i) {  // the q tile, into the scratch
    const int idx = tid + i * THREADS, r = idx / S::CH, c = (idx % S::CH) * 8;
    const bool ok = i0 + r < len;
    cp_async16(scratch_s + (r * S::LD + c) * 2, qb + (size_t)(ok ? i0 + r : 0) * d + c, ok);
  }
  cp_async_commit();
  load_tile(k_s, kb, 0, len);
  load_positions(p_first, S::RING);
  cp_async_commit();

  // q + u and q + v of the warp's 16 rows as mma A fragments, rounded once
  // and kept in registers.  (At d_head 128 the kernel then takes the 255
  // registers a thread has and spills 60 bytes; q + u kept in shared memory
  // instead needed 144 registers and no spill, and ran 3-4 % slower.)
  cp_async_wait<1>();
  __syncthreads();
  unsigned qu[S::KT][4], qv[S::KT][4];
  {
    const float* bu = bias_u + head * DH;
    const float* bv = bias_v + head * DH;
    const unsigned a_lane = ((warp * 16 + lane % 16) * S::LD + (lane / 16) * 8) * 2;
#pragma unroll
    for (int kk = 0; kk < S::KT; ++kk) {
      unsigned a[4];
      ldsm_x4(a, scratch_s + a_lane + kk * 32);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a[e]: row g + 8 (e % 2), columns 2 t4 + 8 (e / 2)
        const int col = kk * 16 + 2 * t4 + 8 * (e / 2);
        qu[kk][e] = biased(a[e], bu, col, scale);
        qv[kk][e] = biased(a[e], bv, col, scale);
      }
    }
  }

  float o[S::OT][4];
#pragma unroll
  for (int n = 0; n < S::OT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float* stage = reinterpret_cast<float*>(smem + S::S_OFF) + warp * 16 * S::SLD;
  // ldmatrix lane offsets: B fragments of k and the positions (rows n, 16
  // columns of d_head), and of v transposed (rows = keys).
  const int b_row = (lane / 16) * 8 + lane % 8, b_col = ((lane / 8) % 2) * 8;
  const int t_row = lane % 8 + ((lane / 8) % 2) * 8, t_col = (lane / 16) * 8;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * S::BN;
    cp_async_wait<0>();  // k and the positions of this tile (this thread's copies)
    __syncthreads();     // ... everyone's; every warp is done with v and the q tile
    load_tile(v_s, vb, j0, len);
    cp_async_commit();

    // Content scores: q + u times the key tile.
    float s[S::NT][4];
#pragma unroll
    for (int n = 0; n < S::NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < S::KT; ++kk) {
#pragma unroll
      for (int n = 0; n < S::NT; n += 2) {
        unsigned b[4];
        ldsm_x4(b, k_s + ((n * 8 + b_row) * S::LD + kk * 16 + b_col) * 2);
        mma_bf16(s[n], qu[kk], b[0], b[1]);
        mma_bf16(s[n + 1], qu[kk], b[2], b[3]);
      }
    }
    // Position scores: q + v times the warp's window of position rows
    // (window column w is row pw + w), staged in float32.
    const int pw = p_first + j0 + S::BM - 16 * (warp + 1);
#pragma unroll
    for (int n = 0; n < S::WIN / 8; n += 2) {
      float r[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const unsigned slot = (unsigned)((pw + n * 8 + b_row) & (S::RING - 1));
#pragma unroll
      for (int kk = 0; kk < S::KT; ++kk) {
        unsigned b[4];
        ldsm_x4(b, p_s + (slot * S::LD + kk * 16 + b_col) * 2);
        mma_bf16(r[0], qv[kk], b[0], b[1]);
        mma_bf16(r[1], qv[kk], b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (n + h) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(stage + g * S::SLD + col) = make_float2(r[h][0], r[h][1]);
        *reinterpret_cast<float2*>(stage + (g + 8) * S::SLD + col) =
            make_float2(r[h][2], r[h][3]);
      }
    }
    __syncthreads();  // every warp is done with this key tile and its oldest BN positions
    if (kt + 1 < n_kt) {
      load_tile(k_s, kb, j0 + S::BN, len);
      load_positions(p_first + j0 + S::RING, S::BN);
    }
    cp_async_commit();

    // The shift: query row i of the warp takes window column (15 - i) + j.
    __syncwarp();
#pragma unroll
    for (int n = 0; n < S::NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + 8 * (e / 2), j = n * 8 + 2 * t4 + (e % 2);
        s[n][e] += stage[i * S::SLD + 15 - i + j];
      }
    }
    if (j0 + S::BN > len) {  // keys at or past the row's length
#pragma unroll
      for (int n = 0; n < S::NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j0 + n * 8 + 2 * t4 + (e % 2) >= len) s[n][e] = -INFINITY;
        }
      }
    }

    // Online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3), each spread
    // over the 4 threads of a quad.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < S::NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float corr = exp2f((m_run[h] - mx[h]) * LOG2E);  // 0 at the first tile
      m_run[h] = mx[h];
      l_run[h] *= corr;
#pragma unroll
      for (int n = 0; n < S::OT; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
    }
    unsigned pa[S::BN / 16][4];  // the bf16 weights as A fragments of 16 keys
#pragma unroll
    for (int n = 0; n < S::NT; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[n][e], LOG2E, -mx[e / 2] * LOG2E));
        l_run[e / 2] += p[e];
      }
      pa[n / 2][2 * (n % 2)] = pack_bf16(p[0], p[1]);
      pa[n / 2][2 * (n % 2) + 1] = pack_bf16(p[2], p[3]);
    }

    cp_async_wait<1>();  // v of this tile (this thread's copies)
    __syncthreads();     // ... everyone's
#pragma unroll
    for (int kc = 0; kc < S::BN / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < S::OT; n += 2) {
        unsigned b[4];
        ldsm_x4_trans(b, v_s + ((kc * 16 + t_row) * S::LD + n * 8 + t_col) * 2);
        mma_bf16(o[n], pa[kc], b[0], b[1]);
        mma_bf16(o[n + 1], pa[kc], b[2], b[3]);
      }
    }
  }

  // Divide by each row's sum once; rows at or past the length stay zero.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    const int i = i0 + warp * 16 + g + 8 * h;
    if (i >= len) continue;
    const float inv = 1.0f / l_run[h];
    bf16* dst = out + base + (size_t)i * d + 2 * t4;
#pragma unroll
    for (int n = 0; n < S::OT; ++n) {
      *reinterpret_cast<unsigned*>(dst + n * 8) =
          pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pe,
                   const void* bias_u, const void* bias_v, const void* items, void* out,
                   int n_items, int tq, int n_heads, float scale, cudaStream_t stream) {
  static bool attributes_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attributes_set[dev]) {
    err = cudaFuncSetAttribute(rel_attention_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<DH>::SMEM);
    if (err != cudaSuccess) return err;
    attributes_set[dev] = true;
  }
  rel_attention_kernel<DH><<<n_items * n_heads, THREADS, Shape<DH>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(pe), static_cast<const float*>(bias_u),
      static_cast<const float*>(bias_v), static_cast<const int4*>(items),
      static_cast<bf16*>(out), tq, n_heads, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches one layer's attention on `stream` over the `n_items` (row, query
// tile, length, 0) items, each for every head, and returns the launch's
// cudaError_t (0 = success).  Does not synchronise and allocates nothing.
extern "C" int tone_rel_attention(const void* q, const void* k, const void* v, const void* pe,
                                  const void* bias_u, const void* bias_v, const void* items,
                                  void* out, int n_items, int tq, int n_heads, int d_head,
                                  float scale, void* stream) {
  if (n_items <= 0 || tq <= 0 || n_heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_head) {
    case 32:
      return (int)launch<32>(q, k, v, pe, bias_u, bias_v, items, out, n_items, tq, n_heads,
                             scale, s);
    case 64:
      return (int)launch<64>(q, k, v, pe, bias_u, bias_v, items, out, n_items, tq, n_heads,
                             scale, s);
    case 128:
      return (int)launch<128>(q, k, v, pe, bias_u, bias_v, items, out, n_items, tq, n_heads,
                              scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
