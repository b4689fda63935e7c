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
// x is NCHW [B, C, T, F], contiguous, bf16 or f32; arithmetic is f32 and
// each output is rounded once. Every pass is bound by device memory:
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
// Work is cut into units of N elements along a row (16 bytes when the
// wrapper found every pointer 16-byte aligned and the rows allow it, else
// one element; relu_pool units are N columns of two rows). Block (chunk, c)
// takes kChunk units of channel c across the batch; each thread keeps
// kUnroll 16-byte loads in flight before it uses them. The cut is made here
// (make_cut); the wrapper asks only how many partials a channel takes.

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

int last_error() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

const char* sedx_bn_error_string(int code) {
  if (code == kErrDtype) return "unsupported dtype or activation";
  if (code == kErrUnits) return "too many units a channel for an int index";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry takes x's shape [B, C, T, F], `aligned` (every pointer it is
// given is 16-byte aligned), launches on `stream` and returns
// cudaGetLastError() (0 on success), or a negative code for a dtype,
// activation or size it does not take.

// The partials a channel of K1 (act 0) or K3 writes: `part` of
// sedx_bn_stats and sedx_bn_grad_stats holds C times this many float2.
int sedx_bn_partials(int B, int C, int T, int F, int dtype, int act,
                     int aligned) {
  Cut cut;
  const int rc = make_cut(B, C, T, F, dtype, act, aligned, cut);
  return rc ? rc : cut.nchunk;
}

// K1 + finalize: out[2C] = (Σx, Σx²) per channel.
int sedx_bn_stats(const void* x, int dtype, int aligned, int B, int C, int T,
                  int F, void* part, float* out, void* stream) {
  Cut cut;
  int rc = make_cut(B, C, T, F, dtype, kNone, aligned, cut);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(part);
  rc = dispatch(dtype, kNone, cut.vec,
                StatsLaunch{x, cut.g, cut.nchunk, p, s});
  if (rc) return rc;
  sedx_bn_finalize_kernel<<<C, kThreads, 0, s>>>(p, cut.nchunk, C, out);
  return last_error();
}

// K2: y = act(x·a + b) (relu_pool: pooled [B, C, T/2, F/2]).
int sedx_bn_apply(const void* x, int dtype, int act, int aligned,
                  const float* a, const float* b, int B, int C, int T, int F,
                  void* y, void* stream) {
  Cut cut;
  int rc = make_cut(B, C, T, F, dtype, act, aligned, cut);
  if (rc) return rc;
  rc = dispatch(dtype, act, cut.vec,
                ApplyLaunch{x, a, b, cut.g, cut.nchunk, y,
                            static_cast<cudaStream_t>(stream)});
  return rc ? rc : last_error();
}

// K3 + finalize: out[2C] = (Σg, Σg·x) per channel.
int sedx_bn_grad_stats(const void* dy, const void* x, int dtype, int act,
                       int aligned, const float* a, const float* b, int B,
                       int C, int T, int F, void* part, float* out,
                       void* stream) {
  Cut cut;
  int rc = make_cut(B, C, T, F, dtype, act, aligned, cut);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(part);
  rc = dispatch(dtype, act, cut.vec,
                GradStatsLaunch{dy, x, a, b, cut.g, cut.nchunk, p, s});
  if (rc) return rc;
  sedx_bn_finalize_kernel<<<C, kThreads, 0, s>>>(p, cut.nchunk, C, out);
  return last_error();
}

// K4 (+ the tail for relu_pool on an odd T or F, one block a plane): dx.
int sedx_bn_grad_x(const void* dy, const void* x, int dtype, int act,
                   int aligned, const float* a, const float* b,
                   const float* gs, int B, int C, int T, int F, void* dx,
                   void* stream) {
  Cut cut;
  int rc = make_cut(B, C, T, F, dtype, act, aligned, cut);
  if (rc) return rc;
  rc = dispatch(dtype, act, cut.vec,
                GradXLaunch{dy, x, a, b, gs, cut.g, cut.nchunk, B * C, dx,
                            static_cast<cudaStream_t>(stream)});
  return rc ? rc : last_error();
}

}  // extern "C"
