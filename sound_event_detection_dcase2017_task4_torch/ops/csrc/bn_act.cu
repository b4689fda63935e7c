// Train-mode BatchNorm of the conv stack, with its activation and 2x2 pool,
// in four passes over each conv output: two forward, two backward.
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm, ReLU and the
// pool to XLA, which fuses them. Eager PyTorch does not, and its composite
// (an f32 copy of x, x*x, two reductions, two bf16 passes for x*a + b, ReLU,
// avg_pool2d, and a dozen passes back through them) moves ~100 bytes per
// conv-output element a step. These kernels move ~16 (relu, none) or ~11.5
// (relu_pool), which is as close to the least I/O as four passes get.
//
// x is [B, C, T, F], bf16 or f32, contiguous NCHW or channels-last (the
// conv stack's layout: cuDNN's bf16 convolutions are NHWC kernels); each
// pass has a kernel for each layout, named with _nhwc for channels-last.
// Arithmetic is f32 and each output is rounded once, in both. Every pass is
// bound by device memory:
//
//   K1 sedx_bn_stats_kernel      x            -> per-block (Σx, Σx²)
//   K3 sedx_bn_grad_stats_kernel dy, x        -> per-block (Σg, Σg·x)
//      sedx_bn_finalize_kernel   partials     -> [2C] f32, fixed order
//   K2 sedx_bn_apply_kernel      x, a, b      -> act(x·a + b)
//   K4 sedx_bn_grad_x_kernel     dy, x, a, b, gs -> dx = g·a + c1 + c2·x
//      sedx_bn_grad_x_tail_kernel: dx of the rows and columns a floor pool
//      drops (g = 0 there)
//
// with g the gradient at z = x·a + b (ReLU's mask recomputed from x; for
// relu_pool dy/4 spread over each 2x2 window), c1 = gs[c], c2 = 2·gs[C + c].
// The reductions are deterministic: each block writes its partial to scratch
// and one block per channel combines them in a fixed order (no atomics), so
// repeated runs and ranks agree bit for bit.
//
// NCHW work is cut into units of N elements along a row (16 bytes when the
// wrapper found every pointer 16-byte aligned and the rows allow it, else
// one element; relu_pool units are N columns of two rows). Block (chunk, c)
// takes kChunk units of channel c across the batch; each thread keeps
// kUnroll 16-byte loads in flight before it uses them. The cut is made here
// (make_cut); the wrapper asks only how many partials a channel takes. The
// channels-last cut (make_cut_nhwc) is described with its kernels below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * kUnroll * 4;  // units a block
constexpr int kTailThreads = 64;
// units a channel (B · units a plane) stay below this, for the int unit index
constexpr long long kMaxUnits = (1ll << 31) - (1ll << 20);

enum Act { kNone = 0, kRelu = 1, kReluPool = 2 };
constexpr int kF32 = 0, kBF16 = 1;
constexpr int kErrDtype = -1, kErrUnits = -2;

struct Geom {
  int C, T, F, To, Fo;  // channels, plane, pooled plane (relu_pool)
  long long P;          // T * F
  int U;                // units per plane
  int FU;               // units per pooled row (relu_pool)
  int total;            // units per channel: B * U
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N elements at p as float: one 16- or 8-byte load when VEC (the wrapper
// found p aligned), else N scalar loads.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[N]) {
  if constexpr (VEC && N * sizeof(T) == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(e[i]);
  } else if constexpr (VEC && N * sizeof(T) == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(p[i]);
  }
}

// M floats to p, rounded once: one 16- or 8-byte store when VEC.
template <typename T, int M, bool VEC>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[M]) {
  if constexpr (VEC && M * sizeof(T) == 16) {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < M; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = r;
  } else if constexpr (VEC && M * sizeof(T) == 8) {
    uint2 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < M; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint2*>(p) = r;
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) p[i] = from_f<T>(v[i]);
  }
}

// ReLU that keeps a NaN, as torch.relu does.
__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

// Sum two values over the block in a fixed order; thread 0 holds the result.
template <typename A>
__device__ __forceinline__ void block_sum2(A& s, A& q) {
  __shared__ A sh[2][kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = s;
    sh[1][warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? sh[0][lane] : A(0);
    q = lane < kThreads / 32 ? sh[1][lane] : A(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
  }
}

// Offset of flat unit u of channel c.
__device__ __forceinline__ long long flat_offset(const Geom& g, int c, int u,
                                                 int n) {
  const int b = u / g.U;
  const int e = u - b * g.U;
  return ((long long)b * g.C + c) * g.P + (long long)e * n;
}

// Offsets of pooled unit u of channel c: the first input row's (the second
// is F further) and the pooled output's.
__device__ __forceinline__ void pool_offsets(const Geom& g, int c, int u, int n,
                                             long long& in, long long& out) {
  const int b = u / g.U;
  const int e = u - b * g.U;
  const int i = e / g.FU;
  const int j = e - i * g.FU;
  const long long plane = (long long)b * g.C + c;
  in = (plane * g.T + 2 * i) * g.F + (long long)j * n;
  out = (plane * g.To + i) * g.Fo + (long long)j * (n / 2);
}

// K1: per-block (Σx, Σx²) of channel blockIdx.y over its chunk of units.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_stats_kernel(const T* __restrict__ x, Geom g,
                         float2* __restrict__ part) {
  const int c = blockIdx.y;
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, g.total);
  float s = 0.f, q = 0.f;
  for (int u0 = start + threadIdx.x; u0 < end; u0 += kThreads * kUnroll) {
    float v[kUnroll][N];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + k * kThreads;
      if (u < end) {
        load<T, N, VEC>(x + flat_offset(g, c, u, N), v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) v[k][i] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s += v[k][i];
        q = fmaf(v[k][i], v[k][i], q);
      }
    }
  }
  block_sum2(s, q);
  if (threadIdx.x == 0)
    part[(long long)c * gridDim.x + blockIdx.x] = make_float2(s, q);
}

// K3: per-block (Σg, Σg·x) of channel blockIdx.y, g the gradient at z.
template <typename T, int ACT, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_grad_stats_kernel(const T* __restrict__ dy,
                              const T* __restrict__ x,
                              const float* __restrict__ a,
                              const float* __restrict__ b, Geom g,
                              float2* __restrict__ part) {
  const int c = blockIdx.y;
  const float ac = a[c], bc = b[c];
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, g.total);
  float s = 0.f, q = 0.f;
  if constexpr (ACT == kReluPool) {
    constexpr int M = N / 2;
    for (int u0 = start + threadIdx.x; u0 < end; u0 += kThreads * kUnroll) {
      float x0[kUnroll][N], x1[kUnroll][N], d[kUnroll][M];
      bool ok[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int u = u0 + k * kThreads;
        ok[k] = u < end;
        if (ok[k]) {
          long long in, out;
          pool_offsets(g, c, u, N, in, out);
          load<T, N, VEC>(x + in, x0[k]);
          load<T, N, VEC>(x + in + g.F, x1[k]);
          load<T, M, VEC>(dy + out, d[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (!ok[k]) continue;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float dd = 0.25f * d[k][m];
          const float xs[4] = {x0[k][2 * m], x0[k][2 * m + 1], x1[k][2 * m],
                               x1[k][2 * m + 1]};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float gg = fmaf(xs[p], ac, bc) > 0.f ? dd : 0.f;
            s += gg;
            q = fmaf(gg, xs[p], q);
          }
        }
      }
    }
  } else {
    for (int u0 = start + threadIdx.x; u0 < end; u0 += kThreads * kUnroll) {
      float xv[kUnroll][N], dv[kUnroll][N];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int u = u0 + k * kThreads;
        if (u < end) {
          const long long off = flat_offset(g, c, u, N);
          load<T, N, VEC>(x + off, xv[k]);
          load<T, N, VEC>(dy + off, dv[k]);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) xv[k][i] = dv[k][i] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float gg = dv[k][i];
          if constexpr (ACT == kRelu)
            gg = fmaf(xv[k][i], ac, bc) > 0.f ? gg : 0.f;
          s += gg;
          q = fmaf(gg, xv[k][i], q);
        }
      }
    }
  }
  block_sum2(s, q);
  if (threadIdx.x == 0)
    part[(long long)c * gridDim.x + blockIdx.x] = make_float2(s, q);
}

// One block a channel: the channel's n partials summed in a fixed order, in
// double; out[c] and out[C + c] as float.
__global__ void __launch_bounds__(kThreads)
    sedx_bn_finalize_kernel(const float2* __restrict__ part, int n, int C,
                            float* __restrict__ out) {
  const int c = blockIdx.x;
  double s = 0.0, q = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = part[(long long)c * n + i];
    s += p.x;
    q += p.y;
  }
  block_sum2(s, q);
  if (threadIdx.x == 0) {
    out[c] = (float)s;
    out[C + c] = (float)q;
  }
}

// K2: y = act(x·a + b); relu_pool writes only the 2x2 floor average pool.
template <typename T, int ACT, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                         const float* __restrict__ b, Geom g,
                         T* __restrict__ y) {
  const int c = blockIdx.y;
  const float ac = a[c], bc = b[c];
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, g.total);
  for (int u0 = start + threadIdx.x; u0 < end; u0 += kThreads * kUnroll) {
    if constexpr (ACT == kReluPool) {
      constexpr int M = N / 2;
      float x0[kUnroll][N], x1[kUnroll][N];
      long long out[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int u = u0 + k * kThreads;
        if (u < end) {
          long long in;
          pool_offsets(g, c, u, N, in, out[k]);
          load<T, N, VEC>(x + in, x0[k]);
          load<T, N, VEC>(x + in + g.F, x1[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u0 + k * kThreads >= end) continue;
        float o[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          // the window in avg_pool2d's order: row 0 left, right, row 1
          float t = relu(fmaf(x0[k][2 * m], ac, bc));
          t += relu(fmaf(x0[k][2 * m + 1], ac, bc));
          t += relu(fmaf(x1[k][2 * m], ac, bc));
          t += relu(fmaf(x1[k][2 * m + 1], ac, bc));
          o[m] = 0.25f * t;
        }
        store<T, M, VEC>(y + out[k], o);
      }
    } else {
      float v[kUnroll][N];
      long long off[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int u = u0 + k * kThreads;
        if (u < end) {
          off[k] = flat_offset(g, c, u, N);
          load<T, N, VEC>(x + off[k], v[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u0 + k * kThreads >= end) continue;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float z = fmaf(v[k][i], ac, bc);
          v[k][i] = ACT == kRelu ? relu(z) : z;
        }
        store<T, N, VEC>(y + off[k], v[k]);
      }
    }
  }
}

// K4: dx = g·a + c1 + c2·x with c1 = gs[c], c2 = 2·gs[C + c].
template <typename T, int ACT, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_grad_x_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ gs, Geom g,
                          T* __restrict__ dx) {
  const int c = blockIdx.y;
  const float ac = a[c], bc = b[c], c1 = gs[c], c2 = 2.f * gs[g.C + c];
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, g.total);
  for (int u0 = start + threadIdx.x; u0 < end; u0 += kThreads * kUnroll) {
    if constexpr (ACT == kReluPool) {
      constexpr int M = N / 2;
      float x0[kUnroll][N], x1[kUnroll][N], d[kUnroll][M];
      long long in[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int u = u0 + k * kThreads;
        if (u < end) {
          long long out;
          pool_offsets(g, c, u, N, in[k], out);
          load<T, N, VEC>(x + in[k], x0[k]);
          load<T, N, VEC>(x + in[k] + g.F, x1[k]);
          load<T, M, VEC>(dy + out, d[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u0 + k * kThreads >= end) continue;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float dd = 0.25f * d[k][m];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& r0 = x0[k][2 * m + h];
            float& r1 = x1[k][2 * m + h];
            const float g0 = fmaf(r0, ac, bc) > 0.f ? dd : 0.f;
            const float g1 = fmaf(r1, ac, bc) > 0.f ? dd : 0.f;
            r0 = fmaf(g0, ac, fmaf(c2, r0, c1));
            r1 = fmaf(g1, ac, fmaf(c2, r1, c1));
          }
        }
        store<T, N, VEC>(dx + in[k], x0[k]);
        store<T, N, VEC>(dx + in[k] + g.F, x1[k]);
      }
    } else {
      float xv[kUnroll][N], dv[kUnroll][N];
      long long off[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int u = u0 + k * kThreads;
        if (u < end) {
          off[k] = flat_offset(g, c, u, N);
          load<T, N, VEC>(x + off[k], xv[k]);
          load<T, N, VEC>(dy + off[k], dv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u0 + k * kThreads >= end) continue;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float gg = dv[k][i];
          if constexpr (ACT == kRelu)
            gg = fmaf(xv[k][i], ac, bc) > 0.f ? gg : 0.f;
          xv[k][i] = fmaf(gg, ac, fmaf(c2, xv[k][i], c1));
        }
        store<T, N, VEC>(dx + off[k], xv[k]);
      }
    }
  }
}

// dx = c1 + c2·x on what a floor pool drops: row T-1 when T is odd, column
// F-1 (of the kept rows) when F is odd. One block a (b, c) plane.
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
    sedx_bn_grad_x_tail_kernel(const T* __restrict__ x,
                               const float* __restrict__ gs, Geom g,
                               T* __restrict__ dx) {
  const long long plane = blockIdx.x;
  const int c = (int)(plane % g.C);
  const float c1 = gs[c], c2 = 2.f * gs[g.C + c];
  const int rows = (g.T - 2 * g.To) * g.F;    // the dropped row, whole
  const int cols = (g.F - 2 * g.Fo) * 2 * g.To;  // the dropped column
  for (int k = threadIdx.x; k < rows + cols; k += kTailThreads) {
    const int t = k < rows ? 2 * g.To : k - rows;
    const int f = k < rows ? k : 2 * g.Fo;
    const long long off = plane * g.P + (long long)t * g.F + f;
    dx[off] = from_f<T>(fmaf(c2, to_f(x[off]), c1));
  }
}

// ---------------------------------------------------------------------------
// Channels-last: x [B, C, T, F] with strides (T·F·C, 1, F·C, C), so memory
// holds a pixel's C channels side by side. These kernels are no NCHW kernel
// with other offsets: a block takes a tile of pixels × Gt groups of N
// channels (N of 16 bytes when the wrapper found every pointer aligned and
// C splits into them, else 1). Thread (r, gi) owns group blockIdx.y·Gt + gi
// for its whole life, so its a, b (and c1, c2) load once, and neighbouring
// threads read neighbouring groups of one pixel's row. Row r of the block
// walks pixels start + r, + R, ... with kUnroll raw loads in flight. K1 and
// K3 sum each channel in registers, add the block's R rows in shared memory
// in a fixed tree order and write one partial per (block, channel); the
// finalize above adds them in a fixed order, as for NCHW.
// ---------------------------------------------------------------------------

constexpr int kGroupsMax = 32;  // channel groups a block
constexpr int kSteps = 8;       // kUnroll-deep steps a pixel row takes a block

struct GeomL {
  int C, T, F, To, Fo;
  int G;      // channel groups of N
  int Gt;     // groups a block: min(G, kGroupsMax)
  int R;      // pixel rows a block: kThreads / Gt
  int npix;   // pixels a pass walks: B·T·F (flat) or B·To·Fo (relu_pool)
  int chunk;  // pixels a block: R · kUnroll · kSteps
};

// N elements as loaded: one 16-byte load when VEC.
template <typename T, int N>
struct alignas(N * sizeof(T) >= 16 ? 16 : sizeof(T)) Pack {
  T e[N];
};

template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_raw(const T* __restrict__ p,
                                         Pack<T, N>& v) {
  if constexpr (VEC) {
    static_assert(N * sizeof(T) == 16, "a vector is 16 bytes");
    *reinterpret_cast<uint4*>(v.e) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v.e[i] = p[i];
  }
}

// This thread's pixel row, its first channel, and whether it holds a group.
struct Lane {
  int r, c0;
  bool on;
};

__device__ __forceinline__ Lane lane(const GeomL& g, int n) {
  const int r = threadIdx.x / g.Gt;
  const int grp = blockIdx.y * g.Gt + (threadIdx.x - r * g.Gt);
  return {r, grp * n, r < g.R && grp < g.G};
}

// Offset of relu_pool output pixel p's window (its top-left input pixel);
// the window's other three are C, F·C and F·C + C further.
__device__ __forceinline__ long long window_offset(const GeomL& g, int p) {
  const int per = g.To * g.Fo;
  const int b = p / per;
  const int e = p - b * per;
  const int i = e / g.Fo;
  const int j = e - i * g.Fo;
  return (((long long)b * g.T + 2 * i) * g.F + 2 * j) * g.C;
}

// Sum s and q over the block's R pixel rows, in a fixed tree order; row 0
// holds the result. Threads of no group hold zeros.
template <int N>
__device__ __forceinline__ void rows_sum(float (&s)[N], float (&q)[N],
                                         const Lane& l, const GeomL& g) {
  __shared__ float sh[2][N][kThreads];
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sh[0][i][t] = s[i];
    sh[1][i][t] = q[i];
  }
  __syncthreads();
  int h = 1;
  while (h < g.R) h <<= 1;
  for (h >>= 1; h > 0; h >>= 1) {
    if (l.r < h && l.r + h < g.R) {
      const int o = t + h * g.Gt;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        sh[0][i][t] += sh[0][i][o];
        sh[1][i][t] += sh[1][i][o];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = sh[0][i][t];
    q[i] = sh[1][i][t];
  }
}

// Row 0's sums as the block's partial of each of its channels.
template <int N>
__device__ __forceinline__ void write_partials(const float (&s)[N],
                                               const float (&q)[N],
                                               const Lane& l,
                                               float2* __restrict__ part) {
  if (!l.on || l.r != 0) return;
#pragma unroll
  for (int i = 0; i < N; ++i)
    part[(long long)(l.c0 + i) * gridDim.x + blockIdx.x] =
        make_float2(s[i], q[i]);
}

// The [C] vectors of this thread's channels.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ v,
                                         const Lane& l, float (&out)[N],
                                         float scale = 1.f, int shift = 0) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = l.on ? scale * v[shift + l.c0 + i] : 0.f;
}

// K1, channels-last: per-block (Σx, Σx²) of each channel of the block's tile.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_stats_nhwc_kernel(const T* __restrict__ x, GeomL g,
                              float2* __restrict__ part) {
  const Lane l = lane(g, N);
  const int start = blockIdx.x * g.chunk;
  const int end = min(start + g.chunk, g.npix);
  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = q[i] = 0.f;
  if (l.on) {
    for (int p0 = start + l.r; p0 < end; p0 += kUnroll * g.R) {
      Pack<T, N> v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = p0 + k * g.R;
        if (p < end) {
          load_raw<T, N, VEC>(x + (long long)p * g.C + l.c0, v[k]);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) v[k].e[i] = from_f<T>(0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xv = to_f(v[k].e[i]);
          s[i] += xv;
          q[i] = fmaf(xv, xv, q[i]);
        }
      }
    }
  }
  rows_sum<N>(s, q, l, g);
  write_partials<N>(s, q, l, part);
}

// K3, channels-last: per-block (Σg, Σg·x) of each channel of the tile, g the
// gradient at z. relu_pool walks output pixels: one dy vector and its
// window's four x vectors, in avg_pool2d's order.
template <typename T, int ACT, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_grad_stats_nhwc_kernel(const T* __restrict__ dy,
                                   const T* __restrict__ x,
                                   const float* __restrict__ a,
                                   const float* __restrict__ b, GeomL g,
                                   float2* __restrict__ part) {
  const Lane l = lane(g, N);
  float ac[N], bc[N], s[N], q[N];
  load_vec<N>(a, l, ac);
  load_vec<N>(b, l, bc);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = q[i] = 0.f;
  const int start = blockIdx.x * g.chunk;
  const int end = min(start + g.chunk, g.npix);
  if (l.on) {
    for (int p0 = start + l.r; p0 < end; p0 += kUnroll * g.R) {
      if constexpr (ACT == kReluPool) {
        Pack<T, N> xw[kUnroll][4], d[kUnroll];
        const long long row = (long long)g.F * g.C;
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int p = p0 + k * g.R;
          if (p < end) {
            const long long in = window_offset(g, p) + l.c0;
            load_raw<T, N, VEC>(x + in, xw[k][0]);
            load_raw<T, N, VEC>(x + in + g.C, xw[k][1]);
            load_raw<T, N, VEC>(x + in + row, xw[k][2]);
            load_raw<T, N, VEC>(x + in + row + g.C, xw[k][3]);
            load_raw<T, N, VEC>(dy + (long long)p * g.C + l.c0, d[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (p0 + k * g.R >= end) continue;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float dd = 0.25f * to_f(d[k].e[i]);
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const float xv = to_f(xw[k][w].e[i]);
              const float gg = fmaf(xv, ac[i], bc[i]) > 0.f ? dd : 0.f;
              s[i] += gg;
              q[i] = fmaf(gg, xv, q[i]);
            }
          }
        }
      } else {
        Pack<T, N> xv[kUnroll], dv[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int p = p0 + k * g.R;
          if (p < end) {
            const long long off = (long long)p * g.C + l.c0;
            load_raw<T, N, VEC>(x + off, xv[k]);
            load_raw<T, N, VEC>(dy + off, dv[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (p0 + k * g.R >= end) continue;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float xf = to_f(xv[k].e[i]);
            float gg = to_f(dv[k].e[i]);
            if constexpr (ACT == kRelu)
              gg = fmaf(xf, ac[i], bc[i]) > 0.f ? gg : 0.f;
            s[i] += gg;
            q[i] = fmaf(gg, xf, q[i]);
          }
        }
      }
    }
  }
  rows_sum<N>(s, q, l, g);
  write_partials<N>(s, q, l, part);
}

// K2, channels-last: y = act(x·a + b); relu_pool reads a window's four
// vectors and writes one.
template <typename T, int ACT, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_apply_nhwc_kernel(const T* __restrict__ x,
                              const float* __restrict__ a,
                              const float* __restrict__ b, GeomL g,
                              T* __restrict__ y) {
  const Lane l = lane(g, N);
  if (!l.on) return;
  float ac[N], bc[N];
  load_vec<N>(a, l, ac);
  load_vec<N>(b, l, bc);
  const int start = blockIdx.x * g.chunk;
  const int end = min(start + g.chunk, g.npix);
  for (int p0 = start + l.r; p0 < end; p0 += kUnroll * g.R) {
    if constexpr (ACT == kReluPool) {
      Pack<T, N> xw[kUnroll][4];
      const long long row = (long long)g.F * g.C;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = p0 + k * g.R;
        if (p < end) {
          const long long in = window_offset(g, p) + l.c0;
          load_raw<T, N, VEC>(x + in, xw[k][0]);
          load_raw<T, N, VEC>(x + in + g.C, xw[k][1]);
          load_raw<T, N, VEC>(x + in + row, xw[k][2]);
          load_raw<T, N, VEC>(x + in + row + g.C, xw[k][3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = p0 + k * g.R;
        if (p >= end) continue;
        float o[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          // the window in avg_pool2d's order: row 0 left, right, row 1
          float t = relu(fmaf(to_f(xw[k][0].e[i]), ac[i], bc[i]));
          t += relu(fmaf(to_f(xw[k][1].e[i]), ac[i], bc[i]));
          t += relu(fmaf(to_f(xw[k][2].e[i]), ac[i], bc[i]));
          t += relu(fmaf(to_f(xw[k][3].e[i]), ac[i], bc[i]));
          o[i] = 0.25f * t;
        }
        store<T, N, VEC>(y + (long long)p * g.C + l.c0, o);
      }
    } else {
      Pack<T, N> v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = p0 + k * g.R;
        if (p < end) load_raw<T, N, VEC>(x + (long long)p * g.C + l.c0, v[k]);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = p0 + k * g.R;
        if (p >= end) continue;
        float o[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float z = fmaf(to_f(v[k].e[i]), ac[i], bc[i]);
          o[i] = ACT == kRelu ? relu(z) : z;
        }
        store<T, N, VEC>(y + (long long)p * g.C + l.c0, o);
      }
    }
  }
}

// K4, channels-last: dx = g·a + c1 + c2·x; relu_pool writes a window's four
// vectors from one dy vector (the pixels a floor pool drops: the tail).
template <typename T, int ACT, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_grad_x_nhwc_kernel(const T* __restrict__ dy,
                               const T* __restrict__ x,
                               const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ gs, GeomL g,
                               T* __restrict__ dx) {
  const Lane l = lane(g, N);
  if (!l.on) return;
  float ac[N], bc[N], c1[N], c2[N];
  load_vec<N>(a, l, ac);
  load_vec<N>(b, l, bc);
  load_vec<N>(gs, l, c1);
  load_vec<N>(gs, l, c2, 2.f, g.C);
  const int start = blockIdx.x * g.chunk;
  const int end = min(start + g.chunk, g.npix);
  for (int p0 = start + l.r; p0 < end; p0 += kUnroll * g.R) {
    if constexpr (ACT == kReluPool) {
      Pack<T, N> xw[kUnroll][4], d[kUnroll];
      long long in[kUnroll];
      const long long row = (long long)g.F * g.C;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = p0 + k * g.R;
        if (p < end) {
          in[k] = window_offset(g, p) + l.c0;
          load_raw<T, N, VEC>(x + in[k], xw[k][0]);
          load_raw<T, N, VEC>(x + in[k] + g.C, xw[k][1]);
          load_raw<T, N, VEC>(x + in[k] + row, xw[k][2]);
          load_raw<T, N, VEC>(x + in[k] + row + g.C, xw[k][3]);
          load_raw<T, N, VEC>(dy + (long long)p * g.C + l.c0, d[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (p0 + k * g.R >= end) continue;
        const long long offs[4] = {in[k], in[k] + g.C, in[k] + row,
                                   in[k] + row + g.C};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float o[N];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float xv = to_f(xw[k][w].e[i]);
            const float gg =
                fmaf(xv, ac[i], bc[i]) > 0.f ? 0.25f * to_f(d[k].e[i]) : 0.f;
            o[i] = fmaf(gg, ac[i], fmaf(c2[i], xv, c1[i]));
          }
          store<T, N, VEC>(dx + offs[w], o);
        }
      }
    } else {
      Pack<T, N> xv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = p0 + k * g.R;
        if (p < end) {
          const long long off = (long long)p * g.C + l.c0;
          load_raw<T, N, VEC>(x + off, xv[k]);
          load_raw<T, N, VEC>(dy + off, dv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = p0 + k * g.R;
        if (p >= end) continue;
        float o[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xf = to_f(xv[k].e[i]);
          float gg = to_f(dv[k].e[i]);
          if constexpr (ACT == kRelu)
            gg = fmaf(xf, ac[i], bc[i]) > 0.f ? gg : 0.f;
          o[i] = fmaf(gg, ac[i], fmaf(c2[i], xf, c1[i]));
        }
        store<T, N, VEC>(dx + (long long)p * g.C + l.c0, o);
      }
    }
  }
}

// dx = c1 + c2·x on the pixels a floor pool drops, channels-last: row T-1
// when T is odd, column F-1 (of the kept rows) when F is odd. Row r of
// block bx takes dropped pixel bx·R + r, of `dropped` in all.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sedx_bn_grad_x_tail_nhwc_kernel(const T* __restrict__ x,
                                    const float* __restrict__ gs, GeomL g,
                                    int dropped, T* __restrict__ dx) {
  const Lane l = lane(g, N);
  const int k = blockIdx.x * g.R + l.r;
  if (!l.on || k >= dropped) return;
  const int rows = (g.T - 2 * g.To) * g.F;
  const int per = rows + (g.F - 2 * g.Fo) * 2 * g.To;
  const int b = k / per;
  const int e = k - b * per;
  const int t = e < rows ? 2 * g.To : e - rows;
  const int f = e < rows ? e : 2 * g.Fo;
  const long long off = (((long long)b * g.T + t) * g.F + f) * g.C + l.c0;
  float c1[N], c2[N], o[N];
  load_vec<N>(gs, l, c1);
  load_vec<N>(gs, l, c2, 2.f, g.C);
  Pack<T, N> v;
  load_raw<T, N, VEC>(x + off, v);
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = fmaf(c2[i], to_f(v.e[i]), c1[i]);
  store<T, N, VEC>(dx + off, o);
}

// The unit width N of each path: 16 bytes when vectorised, else one element
// (flat) or one column pair (relu_pool).
template <typename T>
constexpr int vec_n() {
  return 16 / sizeof(T);
}

// The launches of one entry, as a functor whose run<T, ACT, N, VEC>()
// the runtime dispatch below calls.
struct StatsLaunch {
  const void* x;
  Geom g;
  int nchunk;
  float2* part;
  cudaStream_t s;
  template <typename T, int ACT, int N, bool VEC>
  void run() const {
    sedx_bn_stats_kernel<T, N, VEC><<<dim3(nchunk, g.C), kThreads, 0, s>>>(
        static_cast<const T*>(x), g, part);
  }
};

struct ApplyLaunch {
  const void* x;
  const float *a, *b;
  Geom g;
  int nchunk;
  void* y;
  cudaStream_t s;
  template <typename T, int ACT, int N, bool VEC>
  void run() const {
    sedx_bn_apply_kernel<T, ACT, N, VEC>
        <<<dim3(nchunk, g.C), kThreads, 0, s>>>(static_cast<const T*>(x), a,
                                                b, g, static_cast<T*>(y));
  }
};

struct GradStatsLaunch {
  const void *dy, *x;
  const float *a, *b;
  Geom g;
  int nchunk;
  float2* part;
  cudaStream_t s;
  template <typename T, int ACT, int N, bool VEC>
  void run() const {
    sedx_bn_grad_stats_kernel<T, ACT, N, VEC>
        <<<dim3(nchunk, g.C), kThreads, 0, s>>>(static_cast<const T*>(dy),
                                                static_cast<const T*>(x), a, b,
                                                g, part);
  }
};

struct GradXLaunch {
  const void *dy, *x;
  const float *a, *b, *gs;
  Geom g;
  int nchunk, planes;
  void* dx;
  cudaStream_t s;
  template <typename T, int ACT, int N, bool VEC>
  void run() const {
    sedx_bn_grad_x_kernel<T, ACT, N, VEC>
        <<<dim3(nchunk, g.C), kThreads, 0, s>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x), a, b, gs, g,
            static_cast<T*>(dx));
    if (ACT == kReluPool && (g.T % 2 || g.F % 2))
      sedx_bn_grad_x_tail_kernel<T><<<planes, kTailThreads, 0, s>>>(
          static_cast<const T*>(x), gs, g, static_cast<T*>(dx));
  }
};

template <typename T, typename L>
int dispatch_act(int act, bool vec, const L& l) {
  switch (act) {
    case kNone:
      vec ? l.template run<T, kNone, vec_n<T>(), true>()
          : l.template run<T, kNone, 1, false>();
      return 0;
    case kRelu:
      vec ? l.template run<T, kRelu, vec_n<T>(), true>()
          : l.template run<T, kRelu, 1, false>();
      return 0;
    case kReluPool:
      vec ? l.template run<T, kReluPool, vec_n<T>(), true>()
          : l.template run<T, kReluPool, 2, false>();
      return 0;
    default:
      return -1;
  }
}

// l.run<T, ACT, N, VEC>() for the runtime dtype, activation and path.
template <typename L>
int dispatch(int dtype, int act, int vec, const L& l) {
  if (dtype == kF32) return dispatch_act<float>(act, vec != 0, l);
  if (dtype == kBF16) return dispatch_act<__nv_bfloat16>(act, vec != 0, l);
  return -1;
}

// The cut of a [B, C, T, F] tensor for one pass: its geometry, whether it
// takes the 16-byte path (`aligned` and rows that split into 16-byte units)
// and its blocks a channel. K1 takes the flat cut whatever the epilogue.
struct Cut {
  Geom g;
  bool vec;
  int nchunk;
};

int make_cut(int B, int C, int T, int F, int dtype, int act, int aligned,
             Cut& cut) {
  if (dtype != kF32 && dtype != kBF16) return kErrDtype;
  if (act != kNone && act != kRelu && act != kReluPool) return kErrDtype;
  const int vn = dtype == kF32 ? vec_n<float>() : vec_n<__nv_bfloat16>();
  const bool pool = act == kReluPool;
  const long long P = (long long)T * F;
  cut.vec = aligned && (pool ? F % vn == 0 : P % vn == 0);
  const int n = cut.vec ? vn : (pool ? 2 : 1);
  const long long units = pool ? (long long)(T / 2) * (F / n) : P / n;
  const long long total = B * units;
  if (total >= kMaxUnits) return kErrUnits;
  Geom& g = cut.g;
  g.C = C;
  g.T = T;
  g.F = F;
  g.To = T / 2;
  g.Fo = F / 2;
  g.P = P;
  g.U = (int)units;
  g.FU = pool ? F / n : 0;
  g.total = (int)total;
  cut.nchunk = (int)((total + kChunk - 1) / kChunk);
  return 0;
}

// The channels-last cut: the geometry, whether it takes the 16-byte path
// (`aligned` and C a whole number of 16-byte groups) and its grid: blocks of
// pixels × tiles of channel groups. K1 takes the flat cut whatever the
// epilogue; relu_pool's K2-K4 walk output pixels.
struct CutL {
  GeomL g;
  bool vec;
  dim3 grid;
  int dropped;  // pixels a floor pool drops (relu_pool's tail)
};

int make_cut_nhwc(int B, int C, int T, int F, int dtype, int act,
                  int aligned, CutL& cut) {
  if (dtype != kF32 && dtype != kBF16) return kErrDtype;
  if (act != kNone && act != kRelu && act != kReluPool) return kErrDtype;
  const int vn = dtype == kF32 ? vec_n<float>() : vec_n<__nv_bfloat16>();
  // pixels (and the tail's dropped pixels) stay below the int index
  if ((long long)B * T * F >= kMaxUnits) return kErrUnits;
  cut.vec = aligned && C % vn == 0;
  const int n = cut.vec ? vn : 1;
  GeomL& g = cut.g;
  g.C = C;
  g.T = T;
  g.F = F;
  g.To = T / 2;
  g.Fo = F / 2;
  g.G = C / n;
  g.Gt = min(g.G, kGroupsMax);
  g.R = kThreads / g.Gt;
  g.npix = act == kReluPool ? B * g.To * g.Fo : B * T * F;
  g.chunk = g.R * kUnroll * kSteps;
  cut.grid = dim3((g.npix + g.chunk - 1) / g.chunk, (g.G + g.Gt - 1) / g.Gt);
  cut.dropped = B * (T * F - 4 * g.To * g.Fo);
  return 0;
}

struct StatsNhwcLaunch {
  const void* x;
  const CutL& cut;
  float2* part;
  cudaStream_t s;
  template <typename T, int ACT, int N, bool VEC>
  void run() const {
    sedx_bn_stats_nhwc_kernel<T, VEC ? N : 1, VEC>
        <<<cut.grid, kThreads, 0, s>>>(static_cast<const T*>(x), cut.g, part);
  }
};

struct ApplyNhwcLaunch {
  const void* x;
  const float *a, *b;
  const CutL& cut;
  void* y;
  cudaStream_t s;
  template <typename T, int ACT, int N, bool VEC>
  void run() const {
    sedx_bn_apply_nhwc_kernel<T, ACT, VEC ? N : 1, VEC>
        <<<cut.grid, kThreads, 0, s>>>(static_cast<const T*>(x), a, b, cut.g,
                                       static_cast<T*>(y));
  }
};

struct GradStatsNhwcLaunch {
  const void *dy, *x;
  const float *a, *b;
  const CutL& cut;
  float2* part;
  cudaStream_t s;
  template <typename T, int ACT, int N, bool VEC>
  void run() const {
    sedx_bn_grad_stats_nhwc_kernel<T, ACT, VEC ? N : 1, VEC>
        <<<cut.grid, kThreads, 0, s>>>(static_cast<const T*>(dy),
                                       static_cast<const T*>(x), a, b, cut.g,
                                       part);
  }
};

struct GradXNhwcLaunch {
  const void *dy, *x;
  const float *a, *b, *gs;
  const CutL& cut;
  void* dx;
  cudaStream_t s;
  template <typename T, int ACT, int N, bool VEC>
  void run() const {
    constexpr int M = VEC ? N : 1;
    sedx_bn_grad_x_nhwc_kernel<T, ACT, M, VEC><<<cut.grid, kThreads, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), a, b, gs, cut.g,
        static_cast<T*>(dx));
    if (ACT == kReluPool && cut.dropped > 0)
      sedx_bn_grad_x_tail_nhwc_kernel<T, M, VEC>
          <<<dim3((cut.dropped + cut.g.R - 1) / cut.g.R, cut.grid.y),
             kThreads, 0, s>>>(static_cast<const T*>(x), gs, cut.g,
                               cut.dropped, static_cast<T*>(dx));
  }
};

int last_error() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

const char* sedx_bn_error_string(int code) {
  if (code == kErrDtype) return "unsupported dtype or activation";
  if (code == kErrUnits) return "too many units a channel for an int index";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry takes x's shape [B, C, T, F], `aligned` (every pointer it is
// given is 16-byte aligned), `nhwc` (x, and every tensor of x's shape or of
// its pooled shape, is channels-last; else NCHW), launches on `stream` and
// returns cudaGetLastError() (0 on success), or a negative code for a dtype,
// activation or size it does not take.

// The partials a channel of K1 (act 0) or K3 writes: `part` of
// sedx_bn_stats and sedx_bn_grad_stats holds C times this many float2.
int sedx_bn_partials(int B, int C, int T, int F, int dtype, int act,
                     int aligned, int nhwc) {
  if (nhwc) {
    CutL cut;
    const int rc = make_cut_nhwc(B, C, T, F, dtype, act, aligned, cut);
    return rc ? rc : (int)cut.grid.x;
  }
  Cut cut;
  const int rc = make_cut(B, C, T, F, dtype, act, aligned, cut);
  return rc ? rc : cut.nchunk;
}

// K1 + finalize: out[2C] = (Σx, Σx²) per channel.
int sedx_bn_stats(const void* x, int dtype, int aligned, int nhwc, int B,
                  int C, int T, int F, void* part, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(part);
  int n, rc;
  if (nhwc) {
    CutL cut;
    rc = make_cut_nhwc(B, C, T, F, dtype, kNone, aligned, cut);
    if (rc) return rc;
    n = (int)cut.grid.x;
    rc = dispatch(dtype, kNone, cut.vec, StatsNhwcLaunch{x, cut, p, s});
  } else {
    Cut cut;
    rc = make_cut(B, C, T, F, dtype, kNone, aligned, cut);
    if (rc) return rc;
    n = cut.nchunk;
    rc = dispatch(dtype, kNone, cut.vec,
                  StatsLaunch{x, cut.g, cut.nchunk, p, s});
  }
  if (rc) return rc;
  sedx_bn_finalize_kernel<<<C, kThreads, 0, s>>>(p, n, C, out);
  return last_error();
}

// K2: y = act(x·a + b) (relu_pool: pooled [B, C, T/2, F/2]).
int sedx_bn_apply(const void* x, int dtype, int act, int aligned, int nhwc,
                  const float* a, const float* b, int B, int C, int T, int F,
                  void* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (nhwc) {
    CutL cut;
    rc = make_cut_nhwc(B, C, T, F, dtype, act, aligned, cut);
    if (rc) return rc;
    rc = dispatch(dtype, act, cut.vec, ApplyNhwcLaunch{x, a, b, cut, y, s});
  } else {
    Cut cut;
    rc = make_cut(B, C, T, F, dtype, act, aligned, cut);
    if (rc) return rc;
    rc = dispatch(dtype, act, cut.vec,
                  ApplyLaunch{x, a, b, cut.g, cut.nchunk, y, s});
  }
  return rc ? rc : last_error();
}

// K3 + finalize: out[2C] = (Σg, Σg·x) per channel.
int sedx_bn_grad_stats(const void* dy, const void* x, int dtype, int act,
                       int aligned, int nhwc, const float* a, const float* b,
                       int B, int C, int T, int F, void* part, float* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(part);
  int n, rc;
  if (nhwc) {
    CutL cut;
    rc = make_cut_nhwc(B, C, T, F, dtype, act, aligned, cut);
    if (rc) return rc;
    n = (int)cut.grid.x;
    rc = dispatch(dtype, act, cut.vec,
                  GradStatsNhwcLaunch{dy, x, a, b, cut, p, s});
  } else {
    Cut cut;
    rc = make_cut(B, C, T, F, dtype, act, aligned, cut);
    if (rc) return rc;
    n = cut.nchunk;
    rc = dispatch(dtype, act, cut.vec,
                  GradStatsLaunch{dy, x, a, b, cut.g, cut.nchunk, p, s});
  }
  if (rc) return rc;
  sedx_bn_finalize_kernel<<<C, kThreads, 0, s>>>(p, n, C, out);
  return last_error();
}

// K4 (+ the tail for relu_pool on an odd T or F: one block a plane for
// NCHW, R dropped pixels a block for channels-last): dx.
int sedx_bn_grad_x(const void* dy, const void* x, int dtype, int act,
                   int aligned, int nhwc, const float* a, const float* b,
                   const float* gs, int B, int C, int T, int F, void* dx,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (nhwc) {
    CutL cut;
    rc = make_cut_nhwc(B, C, T, F, dtype, act, aligned, cut);
    if (rc) return rc;
    rc = dispatch(dtype, act, cut.vec,
                  GradXNhwcLaunch{dy, x, a, b, gs, cut, dx, s});
  } else {
    Cut cut;
    rc = make_cut(B, C, T, F, dtype, act, aligned, cut);
    if (rc) return rc;
    rc = dispatch(dtype, act, cut.vec,
                  GradXLaunch{dy, x, a, b, gs, cut.g, cut.nchunk, B * C, dx,
                              s});
  }
  return rc ? rc : last_error();
}

}  // extern "C"
