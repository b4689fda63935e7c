// HTS-AT's shifted-window attention core (ops/window_attention.py), forward
// and backward, with a window-head's scores, bias, mask and softmax kept on
// chip: no N×N tensor is written to device memory in either direction.
//
// It replaces no TPU kernel: the JAX package has no HTS-AT. The stock-ops
// version of the core wrote the float32 [W·H, N, N] scores and their
// gradient through device memory about a dozen times a call (scores, the
// bias-and-mask addend, softmax, P's cast; dP, softmax's backward, dS's
// scale and cast, the sum over windows). These kernels read q, k, v (and
// dO) once and write o (and dq, dk, dv) once; what bounds them is device
// memory (~21 bytes of traffic a token-width element, against ~2·N·d
// multiply-adds on the tensor cores), so the design keeps everything of
// size N×N in registers and shared memory and overlaps each window's loads
// with the previous window's arithmetic.
//
//   sedx_wa_forward_kernel   q, k, v            -> o
//   sedx_wa_backward_kernel  q, k, v, dO        -> dq, dk, dv, per-block Σ dS
//   sedx_wa_sum_kernel       per-block Σ dS     -> Σ dS a head, fixed order
//   sedx_wa_scatter_kernel   Σ dS a head        -> the bias table's gradient
//
// q, k, v [W, H, N, d] come as strided views (unit stride over d; the
// wrapper checks 16-byte alignment of the pointers and the other strides),
// W = B·nW windows batch-major, so window w takes mask[w % nW]. o and dO
// are [W, N, H·d] (heads merged), dq, dk, dv [W, H, N, d] with strides. T is
// bf16 (products on the tensor cores, mma.sync m16n8k16 and m16n8k8, float32
// accumulators) or float32 (products as float32 FMAs in order, no TF32).
//
// A block of 4 warps takes one head h and one window index i (the mask's)
// over a run of batch rows b (windows w = b·nW + i): it gathers the head's
// bias rows by the relative index, adds mask[i], keeps that addend
// [64][64] in shared memory for the whole run, and double-buffers the
// windows' q, k, v (dO) tiles with cp.async. The grid runs the heads of a
// window together, so the 32-byte sectors that two heads' rows share are
// read from device memory once, and is cut into as many runs as fill the
// card's resident blocks in the fewest waves (make_cut). N ≤ 64 tokens are
// padded to 64 rows: padded keys get −inf in the addend, padded rows are
// zero and never stored. Warp r owns query rows 16r..16r+15 and holds their
// scores in the mma accumulator layout (operands loaded with ldmatrix):
// S = scale·q kᵀ + addend, P = softmax(S) in float32 (exp by the special
// function unit, the row's sum inverted once); P rounded once to T for
// o = P v.
//
// The backward recomputes S and P, then dP = dO vᵀ (float32),
// dS = P∘(dP − Σ_j dP∘P), dv = Pᵀ dO (P rounded to T), and with dS·scale
// rounded once to T, dq = (dS·scale) k and dk = (dS·scale)ᵀ q; P and
// dS·scale go through shared memory for the transposed products. Each
// thread sums dS over the block's windows in its registers and the block
// writes that partial to scratch. The sum kernel adds the partials of a
// head in a fixed order, and the scatter kernel sums each table row's token
// pairs (by the relative index) in a fixed order: no atomics, so two calls
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // a window-head's tokens, padded: 4 warps × 16
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kAP = 72;  // pitch (floats) of the addend tile
constexpr int kPP = 72;  // pitch (elements) of the P and dS tiles
// a block's fixed cost in windows' time (its addend, first load, partial)
constexpr int kBlockCost = 2;
constexpr int kSumThreads = 256;    // 64 token pairs × 4 partial phases
constexpr int kScatterWarps = 8;    // table rows a scatter block
constexpr int kMaxPairs = kRows * kRows;
constexpr int kF32 = 0, kBF16 = 1;
constexpr int kErrArgs = -1;

using bf16 = __nv_bfloat16;

// Row pitch (elements) of a q, k, v or dO tile: d when d ≡ 8 (mod 16), else
// d + 8, so that the fragment loads of a warp hit 32 different banks.
__host__ __device__ __forceinline__ int tile_pitch(int d) {
  return d % 16 == 8 ? d : d + 8;
}

struct Params {
  const void *q, *k, *v, *dout;
  long long qs[3], ks[3], vs[3];  // strides (w, h, n) in elements
  const float* table;             // [R, H]
  const long long* index;         // [N·N]
  const float* mask;              // [nW, N, N] or null (nW = 1)
  int W, H, N, d, nW, per, nchunk;
  float scale;
  void* o;                        // [W, N, H·d]
  void *dq, *dk, *dv;
  long long dqs[3], dks[3], dvs[3];
  float* part;                    // [H, nW·nchunk, N·N]
};

// ---------------------------------------------------------------------------
// fragments (g = lane / 4, t = lane % 4): an accumulator c[n][0..3] holds
// rows g and g + 8, columns 8n + 2t and 8n + 2t + 1 of a 16-row slab
// ---------------------------------------------------------------------------

// ldmatrix: lane l gives the address of row l % 8 of 8×8 matrix l / 8
// (16 bytes, 16-byte aligned, in shared memory); register j receives
// matrix j's elements (l / 4, 2·(l % 4) + {0, 1}), or with .trans
// (2·(l % 4) + {0, 1}, l / 4): an mma fragment either way.
__device__ __forceinline__ void ldm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
}
__device__ __forceinline__ void ldm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p))
      : "memory");
}
__device__ __forceinline__ void ldm2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
}
__device__ __forceinline__ void ldm2t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[2],
                                        uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// c[n] += A · B over k < K (a multiple of 8), for the column tiles n < on:
// A a 16 × K slab, B a K × 8·NT block, both in shared memory with 16-byte
// aligned rows. A(r, k) lies at a[r·lda + k] when AK (k contiguous), else
// at a[k·lda + r]; B(k, n) at b[n·ldb + k] when BK, else at b[k·ldb + n].
template <int NT, bool AK, bool BK>
__device__ __forceinline__ void mm(float (&c)[NT][4], const bf16* a, int lda,
                                   const bf16* b, int ldb, int K, int on) {
  const int lane = threadIdx.x & 31, m = lane >> 3, rr = lane & 7;
  // A's 16 × 16 block at k0: matrix m holds rows 8·(m & 1).., columns
  // k0 + 8·(m >> 1)..
  const bf16* pa = AK ? a + (rr + 8 * (m & 1)) * lda + 8 * (m >> 1)
                      : a + (rr + 8 * (m >> 1)) * lda + 8 * (m & 1);
  // B's 16 × 16 block of column tiles n, n + 1 at k0: matrix m holds tile
  // n + (m >> 1), rows k0 + 8·(m & 1)..
  const bf16* pb = BK ? b + (rr + 8 * (m >> 1)) * ldb + 8 * (m & 1)
                      : b + (rr + 8 * (m & 1)) * ldb + 8 * (m >> 1);
  const int a_k = AK ? 1 : lda, b_k = BK ? 1 : ldb;  // a step of k
  const int b_n = BK ? 8 * ldb : 8;                  // a column tile
  for (int k0 = 0; k0 + 16 <= K; k0 += 16) {
    uint32_t af[4];
    if (AK) ldm4(af, pa + k0 * a_k); else ldm4t(af, pa + k0 * a_k);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n + 1 < on) {
        uint32_t bf[4];
        const bf16* q = pb + k0 * b_k + n * b_n;
        if (BK) ldm4(bf, q); else ldm4t(bf, q);
        mma16816(c[n], af, bf[0], bf[1]);
        if (n + 1 < NT) mma16816(c[n + 1 < NT ? n + 1 : n], af, bf[2], bf[3]);
      } else if (n < on) {
        uint32_t bf[2];
        const bf16* q = pb + k0 * b_k + n * b_n;
        if (BK) ldm2(bf, q); else ldm2t(bf, q);
        mma16816(c[n], af, bf[0], bf[1]);
      }
    }
  }
  if (K & 8) {  // only the products over d take this step: AK and BK
    const int k0 = K - 8;
    uint32_t af[2];
    ldm2(af, a + (rr + 8 * (m & 1)) * lda + k0);
#pragma unroll
    for (int n = 0; n < NT; n += 4) {
      // matrix m holds column tile n + m, rows k0..k0 + 7
      uint32_t bf[4];
      ldm4(bf, b + (8 * (n + m) + rr) * ldb + k0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < NT && n + j < on) mma1688(c[n + j < NT ? n + j : 0], af, bf[j]);
    }
  }
}

// The same product in float32: each element summed over k in order by FMA.
template <int NT, bool AK, bool BK>
__device__ __forceinline__ void mm(float (&c)[NT][4], const float* a, int lda,
                                   const float* b, int ldb, int K, int on) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float x0 = AK ? a[g * lda + k] : a[k * lda + g];
    const float x1 = AK ? a[(g + 8) * lda + k] : a[k * lda + g + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < on) {
        const int col = 8 * n + 2 * t;
        const float y0 = BK ? b[col * ldb + k] : b[k * ldb + col];
        const float y1 = BK ? b[(col + 1) * ldb + k] : b[k * ldb + col + 1];
        c[n][0] = fmaf(x0, y0, c[n][0]);
        c[n][1] = fmaf(x0, y1, c[n][1]);
        c[n][2] = fmaf(x1, y0, c[n][2]);
        c[n][3] = fmaf(x1, y1, c[n][3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// (x, y) rounded once to T at p (4- or 8-byte aligned).
__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// The slab's accumulators times `mul`, rounded to T, into a shared tile.
template <typename T, int NT>
__device__ __forceinline__ void put_slab(T* dst, int ld, const float (&c)[NT][4],
                                         float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    put2(dst + g * ld + 8 * n + 2 * t, c[n][0] * mul, c[n][1] * mul);
    put2(dst + (g + 8) * ld + 8 * n + 2 * t, c[n][2] * mul, c[n][3] * mul);
  }
}

// Rows r0 + g and r0 + g + 8 (those below N) of a [·, d] output in device
// memory, row stride ld: the column tiles n < on.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* base, long long ld, int r0, int N,
                                           const float (&c)[NT][4], int on) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = r0 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < on) {
      if (r < N) put2(base + r * ld + 8 * n + 2 * t, c[n][0], c[n][1]);
      if (r + 8 < N) put2(base + (r + 8) * ld + 8 * n + 2 * t, c[n][2], c[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 64 rows of d elements (row stride sn) into a shared tile of pitch dp,
// rows from N on zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dp, const T* src,
                                          long long sn, int N, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = d / kVec;
  for (int c = threadIdx.x; c < kRows * per_row; c += kThreads) {
    const int r = c / per_row, x = (c - r * per_row) * kVec;
    const bool in = r < N;
    cp_async16(dst + r * dp + x, in ? src + r * sn + x : src, in ? 16 : 0);
  }
}

// The block's addend: bias_table[index[r·N + c], h] + mask[r, c] for
// r, c < N; 0 on padded rows, −inf on padded columns.
__device__ __forceinline__ void fill_addend(float* add, const Params& p, int h,
                                            const float* mask) {
  const int N = p.N;
#pragma unroll 8
  for (int e = threadIdx.x; e < kRows * kRows; e += kThreads) {
    const int r = e / kRows, c = e % kRows;
    float v;
    if (c >= N) {
      v = -INFINITY;
    } else if (r >= N) {
      v = 0.f;
    } else {
      v = p.table[p.index[r * N + c] * p.H + h];
      if (mask) v += mask[r * N + c];
    }
    add[r * kAP + c] = v;
  }
}

// The warp's rows of q kᵀ → P: scale, the addend, the float32 softmax.
__device__ __forceinline__ void softmax_slab(float (&s)[8][4], const float* add,
                                             int r0, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = add + (r0 + g) * kAP + 2 * t;
  const float* a1 = a0 + 8 * kAP;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 x0 = *reinterpret_cast<const float2*>(a0 + 8 * n);
    const float2 x1 = *reinterpret_cast<const float2*>(a1 + 8 * n);
    s[n][0] = x0.x + scale * s[n][0];
    s[n][1] = x0.y + scale * s[n][1];
    s[n][2] = x1.x + scale * s[n][2];
    s[n][3] = x1.y + scale * s[n][3];
    m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
    m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = __expf(s[n][0] - m0);
    s[n][1] = __expf(s[n][1] - m0);
    s[n][2] = __expf(s[n][2] - m1);
    s[n][3] = __expf(s[n][3] - m1);
    l0 += s[n][0] + s[n][1];
    l1 += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  l0 = 1.f / l0;
  l1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] *= l0;
    s[n][1] *= l0;
    s[n][2] *= l1;
    s[n][3] *= l1;
  }
}

template <typename T>
__host__ __device__ constexpr int fwd_smem(int dp) {
  return kRows * kAP * 4 + (6 * kRows * dp + kRows * kPP) * (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int bwd_smem(int dp) {
  return kRows * kAP * 4 + (8 * kRows * dp + 2 * kRows * kPP) * (int)sizeof(T);
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// Block (chunk, i, h): windows w = b·nW + i for b in the chunk's run.
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
    sedx_wa_forward_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = tile_pitch(p.d), nd = p.d / 8, tile = kRows * dp;
  float* add = reinterpret_cast<float*>(smem);
  T* tiles = reinterpret_cast<T*>(add + kRows * kAP);  // [2][q, k, v]
  T* pt = tiles + 6 * tile;
  const int h = blockIdx.x, i = blockIdx.y;
  const int first = blockIdx.z * p.per;
  const int last = min(p.W / p.nW, first + p.per);
  const T* q = static_cast<const T*>(p.q) + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + h * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + h * p.vs[1];
  auto issue = [&](int b, int buf) {
    const long long w = (long long)b * p.nW + i;
    T* dst = tiles + buf * 3 * tile;
    load_tile(dst, dp, q + w * p.qs[0], p.qs[2], p.N, p.d);
    load_tile(dst + tile, dp, k + w * p.ks[0], p.ks[2], p.N, p.d);
    load_tile(dst + 2 * tile, dp, v + w * p.vs[0], p.vs[2], p.N, p.d);
  };
  if (first < last) issue(first, 0);
  cp_commit();
  fill_addend(add, p, h, p.mask ? p.mask + (long long)i * p.N * p.N : nullptr);
  const int r0 = 16 * (threadIdx.x >> 5);
  T* out = static_cast<T*>(p.o) + h * p.d;
  const long long ld = (long long)p.H * p.d;
  for (int b = first; b < last; ++b) {
    const int buf = (b - first) & 1;
    if (b + 1 < last) issue(b + 1, buf ^ 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const T* qt = tiles + buf * 3 * tile;
    const T* kt = qt + tile;
    const T* vt = kt + tile;
    float s[8][4];
    zero(s);
    mm<8, true, true>(s, qt + r0 * dp, dp, kt, dp, p.d, 8);
    softmax_slab(s, add, r0, p.scale);
    put_slab(pt + r0 * kPP, kPP, s, 1.f);
    __syncwarp();
    float o[DT][4];
    zero(o);
    mm<DT, true, false>(o, pt + r0 * kPP, kPP, vt, dp, kRows, nd);
    const long long w = (long long)b * p.nW + i;
    store_rows(out + w * p.N * ld, ld, r0, p.N, o, nd);
    __syncthreads();
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
    sedx_wa_backward_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = tile_pitch(p.d), nd = p.d / 8, tile = kRows * dp;
  float* add = reinterpret_cast<float*>(smem);
  T* tiles = reinterpret_cast<T*>(add + kRows * kAP);  // [2][q, k, v, dO]
  T* pt = tiles + 8 * tile;                             // P
  T* st = pt + kRows * kPP;                             // dS·scale
  const int h = blockIdx.x, i = blockIdx.y;
  const int first = blockIdx.z * p.per;
  const int last = min(p.W / p.nW, first + p.per);
  const long long ld = (long long)p.H * p.d;
  const T* q = static_cast<const T*>(p.q) + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + h * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + h * p.vs[1];
  const T* dout = static_cast<const T*>(p.dout) + h * p.d;
  auto issue = [&](int b, int buf) {
    const long long w = (long long)b * p.nW + i;
    T* dst = tiles + buf * 4 * tile;
    load_tile(dst, dp, q + w * p.qs[0], p.qs[2], p.N, p.d);
    load_tile(dst + tile, dp, k + w * p.ks[0], p.ks[2], p.N, p.d);
    load_tile(dst + 2 * tile, dp, v + w * p.vs[0], p.vs[2], p.N, p.d);
    load_tile(dst + 3 * tile, dp, dout + w * p.N * ld, ld, p.N, p.d);
  };
  if (first < last) issue(first, 0);
  cp_commit();
  fill_addend(add, p, h, p.mask ? p.mask + (long long)i * p.N * p.N : nullptr);
  const int r0 = 16 * (threadIdx.x >> 5);
  float acc[8][4];  // Σ dS over the block's windows, the slab's elements
  zero(acc);
  for (int b = first; b < last; ++b) {
    const int buf = (b - first) & 1;
    if (b + 1 < last) issue(b + 1, buf ^ 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const T* qt = tiles + buf * 4 * tile;
    const T* kt = qt + tile;
    const T* vt = kt + tile;
    const T* ot = vt + tile;
    float s[8][4], g[8][4];
    zero(s);
    mm<8, true, true>(s, qt + r0 * dp, dp, kt, dp, p.d, 8);
    softmax_slab(s, add, r0, p.scale);
    zero(g);
    mm<8, true, true>(g, ot + r0 * dp, dp, vt, dp, p.d, 8);  // dP
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      d0 += g[n][0] * s[n][0] + g[n][1] * s[n][1];
      d1 += g[n][2] * s[n][2] + g[n][3] * s[n][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // dS = P∘(dP − Σ_j dP∘P)
      g[n][0] = s[n][0] * (g[n][0] - d0);
      g[n][1] = s[n][1] * (g[n][1] - d0);
      g[n][2] = s[n][2] * (g[n][2] - d1);
      g[n][3] = s[n][3] * (g[n][3] - d1);
      acc[n][0] += g[n][0];
      acc[n][1] += g[n][1];
      acc[n][2] += g[n][2];
      acc[n][3] += g[n][3];
    }
    put_slab(pt + r0 * kPP, kPP, s, 1.f);
    put_slab(st + r0 * kPP, kPP, g, p.scale);
    __syncthreads();
    const long long w = (long long)b * p.nW + i;
    float c[DT][4];
    zero(c);
    mm<DT, true, false>(c, st + r0 * kPP, kPP, kt, dp, kRows, nd);
    store_rows(static_cast<T*>(p.dq) + w * p.dqs[0] + h * p.dqs[1], p.dqs[2], r0,
               p.N, c, nd);
    zero(c);
    mm<DT, false, false>(c, pt + r0, kPP, ot, dp, kRows, nd);
    store_rows(static_cast<T*>(p.dv) + w * p.dvs[0] + h * p.dvs[1], p.dvs[2], r0,
               p.N, c, nd);
    zero(c);
    mm<DT, false, false>(c, st + r0, kPP, qt, dp, kRows, nd);
    store_rows(static_cast<T*>(p.dk) + w * p.dks[0] + h * p.dks[1], p.dks[2], r0,
               p.N, c, nd);
    __syncthreads();
  }
  // the block's partial [N, N] of Σ dS
  const int N = p.N, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  float* dst = p.part + ((long long)h * p.nW * p.nchunk + i * p.nchunk + blockIdx.z) * N * N;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + gr + (e >> 1) * 8, c = 8 * n + 2 * t + (e & 1);
      if (r < N && c < N) dst[r * N + c] = acc[n][e];
    }
  }
}

// dsum[h, ij] = Σ over the head's P partials, a fixed order: thread
// (phase f, pair ij) adds the partials f, f + 4, ... in turn, then the four
// phases are added in order.
__global__ void __launch_bounds__(kSumThreads)
    sedx_wa_sum_kernel(const float* part, int P, int NN, float* dsum) {
  __shared__ float sh[4][64];
  const int x = threadIdx.x & 63, f = threadIdx.x >> 6;
  const int ij = blockIdx.x * 64 + x, h = blockIdx.y;
  float s = 0.f;
  if (ij < NN) {
    const float* src = part + (long long)h * P * NN + ij;
#pragma unroll 8
    for (int j = f; j < P; j += 4) s += src[(long long)j * NN];
  }
  sh[f][x] = s;
  __syncthreads();
  if (f == 0 && ij < NN)
    dsum[(long long)h * NN + ij] = ((sh[0][x] + sh[1][x]) + sh[2][x]) + sh[3][x];
}

// dtable[r, h] = Σ_{ij : index[ij] = r} dsum[h, ij]: a warp a table row,
// lane l adding the pairs ij ≡ l (mod 32) in turn, then a fixed shuffle tree.
__global__ void __launch_bounds__(32 * kScatterWarps)
    sedx_wa_scatter_kernel(const float* dsum, const long long* index, int NN,
                           int R, int H, float* dtable) {
  __shared__ int sidx[kMaxPairs];
  __shared__ float sval[kMaxPairs];
  const int h = blockIdx.y;
  for (int e = threadIdx.x; e < NN; e += 32 * kScatterWarps) {
    sidx[e] = (int)index[e];
    sval[e] = dsum[(long long)h * NN + e];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kScatterWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  float s = 0.f;
  for (int e = lane; e < NN; e += 32)
    if (sidx[e] == r) s += sval[e];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) dtable[r * H + h] = s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0, m = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    n = m > 0 ? m : 1;
  }
  return n;
}

// The runs of batch rows the blocks take. A block's time is about its
// windows plus kBlockCost (its addend, its first load, its partial); the
// blocks run in waves of `cap` (the card's resident blocks), so the cut
// that gives the fewest waves × (windows a block + kBlockCost) wins, the
// fewest blocks among equals.
void make_cut(Params& p, int cap) {
  const int nb = p.W / p.nW, pairs = p.H * p.nW;
  const int most = nb < 4 * cap / pairs + 1 ? nb : 4 * cap / pairs + 1;
  long long best = -1;
  int best_per = nb;
  for (int n = 1; n <= most; ++n) {
    const int per = (nb + n - 1) / n, chunks = (nb + per - 1) / per;
    const long long waves = ((long long)pairs * chunks + cap - 1) / cap;
    const long long cost = waves * (per + kBlockCost);
    if (best < 0 || cost < best) {
      best = cost;
      best_per = per;
    }
  }
  p.per = best_per;
  p.nchunk = (nb + best_per - 1) / best_per;
}

// The card's resident blocks of `kern` with `bytes` of dynamic shared
// memory (after allowing it that much), or the error that stopped the
// query. Each instantiation asks once, at its widest head (a narrower one
// takes no more shared memory, so the count never exceeds what fits): a
// static in the launcher keeps the answer.
struct Capacity {
  int rc, blocks;
};

template <typename K>
Capacity capacity(K kern, int bytes) {
  int rc = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc) return {rc, 0};
  int n = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                          bytes);
  if (rc) return {rc, 0};
  if (n < 1) return {kErrArgs, 0};
  return {0, n * sm_count()};
}

int check(int dtype, int W, int H, int N, int d, int nW) {
  if (dtype != kF32 && dtype != kBF16) return kErrArgs;
  if (W < 1 || H < 1 || N < 1 || N > kRows || d < 8 || d > 64 || d % 8)
    return kErrArgs;
  if (nW < 1 || W % nW || nW > 65535 || W / nW > 65535 || H > 65535)
    return kErrArgs;
  return 0;
}

int last_error() { return (int)cudaGetLastError(); }

template <typename T, int DT>
int launch_forward(Params& p, cudaStream_t s) {
  const int bytes = fwd_smem<T>(tile_pitch(p.d));
  auto kern = sedx_wa_forward_kernel<T, DT>;
  // allowed and counted at the instantiation's widest head, d = 8·DT
  static const Capacity cap = capacity(kern, fwd_smem<T>(tile_pitch(8 * DT)));
  if (cap.rc) return cap.rc;
  make_cut(p, cap.blocks);
  kern<<<dim3(p.H, p.nW, p.nchunk), kThreads, bytes, s>>>(p);
  return last_error();
}

// The backward's cut (launch false) or its launch.
template <typename T, int DT>
int launch_backward(Params& p, cudaStream_t s, bool launch) {
  const int bytes = bwd_smem<T>(tile_pitch(p.d));
  auto kern = sedx_wa_backward_kernel<T, DT>;
  // allowed and counted at the instantiation's widest head, d = 8·DT
  static const Capacity cap = capacity(kern, bwd_smem<T>(tile_pitch(8 * DT)));
  if (cap.rc) return cap.rc;
  make_cut(p, cap.blocks);
  if (!launch) return 0;
  kern<<<dim3(p.H, p.nW, p.nchunk), kThreads, bytes, s>>>(p);
  return last_error();
}

int forward_for(int dtype, Params& p, cudaStream_t s) {
  if (dtype == kBF16)
    return p.d <= 24 ? launch_forward<bf16, 3>(p, s) : launch_forward<bf16, 8>(p, s);
  return p.d <= 24 ? launch_forward<float, 3>(p, s) : launch_forward<float, 8>(p, s);
}

int backward_for(int dtype, Params& p, cudaStream_t s, bool launch) {
  if (dtype == kBF16)
    return p.d <= 24 ? launch_backward<bf16, 3>(p, s, launch)
                     : launch_backward<bf16, 8>(p, s, launch);
  return p.d <= 24 ? launch_backward<float, 3>(p, s, launch)
                   : launch_backward<float, 8>(p, s, launch);
}

void set_strides(long long (&dst)[3], const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace

extern "C" {

const char* sedx_wa_error_string(int code) {
  if (code == kErrArgs) return "unsupported dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry takes q, k, v [W, H, N, d] (dtype 0 float32, 1 bf16) with their
// strides (w, h, n) in elements, `nW` the mask's windows (1 without a
// mask), launches on `stream` and returns cudaGetLastError() after each
// launch (0 on success), or a negative code for what it does not take.

// The partials a head of sedx_wa_backward writes (a negative code on
// failure): its `scratch` holds H·(this + 1)·N·N floats.
int sedx_wa_partials(int W, int H, int N, int d, int nW, int dtype) {
  const int rc = check(dtype, W, H, N, d, nW);
  if (rc) return rc;
  Params p{};
  p.W = W;
  p.H = H;
  p.d = d;
  p.nW = nW;
  const int err = backward_for(dtype, p, nullptr, false);
  return err > 0 ? -err : err < 0 ? err : nW * p.nchunk;
}

// o [W, N, H·d], contiguous.
int sedx_wa_forward(const void* q, const void* k, const void* v, int dtype,
                    const long long* qs, const long long* ks,
                    const long long* vs, const float* table,
                    const long long* index, const float* mask, int W, int H,
                    int N, int d, int nW, float scale, void* o, void* stream) {
  const int rc = check(dtype, W, H, N, d, nW);
  if (rc) return rc;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  set_strides(p.qs, qs);
  set_strides(p.ks, ks);
  set_strides(p.vs, vs);
  p.table = table;
  p.index = index;
  p.mask = mask;
  p.W = W;
  p.H = H;
  p.N = N;
  p.d = d;
  p.nW = nW;
  p.scale = scale;
  p.o = o;
  return forward_for(dtype, p, static_cast<cudaStream_t>(stream));
}

// dO [W, N, H·d] contiguous; dq, dk, dv [W, H, N, d] with strides (w, h,
// n); dtable [R, H] float32, every entry written; scratch as
// sedx_wa_partials says.
int sedx_wa_backward(const void* q, const void* k, const void* v,
                     const void* dout, int dtype, const long long* qs,
                     const long long* ks, const long long* vs,
                     const float* table, const long long* index,
                     const float* mask, int W, int H, int N, int d, int nW,
                     int R, float scale, void* dq, void* dk, void* dv,
                     const long long* dqs, const long long* dks,
                     const long long* dvs, float* scratch, float* dtable,
                     void* stream) {
  int rc = check(dtype, W, H, N, d, nW);
  if (rc) return rc;
  if (R < 1) return kErrArgs;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  set_strides(p.qs, qs);
  set_strides(p.ks, ks);
  set_strides(p.vs, vs);
  p.table = table;
  p.index = index;
  p.mask = mask;
  p.W = W;
  p.H = H;
  p.N = N;
  p.d = d;
  p.nW = nW;
  p.scale = scale;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  set_strides(p.dqs, dqs);
  set_strides(p.dks, dks);
  set_strides(p.dvs, dvs);
  p.part = scratch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = backward_for(dtype, p, s, true);
  if (rc) return rc;
  const int NN = N * N, P = nW * p.nchunk;
  float* dsum = scratch + (long long)H * P * NN;
  sedx_wa_sum_kernel<<<dim3((NN + 63) / 64, H), kSumThreads, 0, s>>>(scratch, P,
                                                                     NN, dsum);
  rc = last_error();
  if (rc) return rc;
  sedx_wa_scatter_kernel<<<dim3((R + kScatterWarps - 1) / kScatterWarps, H),
                           32 * kScatterWarps, 0, s>>>(dsum, index, NN, R, H,
                                                       dtable);
  return last_error();
}

}  // extern "C"
