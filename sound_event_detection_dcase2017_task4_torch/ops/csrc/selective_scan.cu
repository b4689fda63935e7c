// Audio Mamba's bidirectional selective scan (ops/selective_scan.py), forward
// and backward, with each (row, channel)'s [16] float32 state in registers.
//
// It replaces no TPU kernel: the JAX package has no Audio Mamba. In stock
// ops the recurrence is either a loop over tokens (a dozen launches a token,
// a direction and a layer) or a parallel scan that writes the [B, L, E, 16]
// states through device memory; here a thread carries one channel of one
// row along the sequence and nothing of size 16 a channel leaves the chip
// but the backward's chunk checkpoints.
//
//   sedx_ss_forward_kernel   u, Δraw, B, C (both directions), z -> out, ysum
//   sedx_ss_backward_kernel  the same, dout, ysum -> du, dΔraw (both), dz,
//                            per-block Σ dB, Σ dC, per-row Σ dA_log, dD, db
//
// Per direction d, token t in the direction's order (fwd: t = 0..L−1; bwd:
// t = L−1..0, read by reversed index, no flipped copy):
//   Δ = softplus(Δraw + b_dt)           A = −exp(A_log)   [E, 16]
//   h_t = exp(Δ A) ⊙ h_{t−1} + Δ u B_t   y_t = C_t · h_t + D u
//   out = (y_fwd + y_bwd) · silu(z) / 2
// u, Δraw, z, out, dout, du, dΔraw, dz are [B, L, E] contiguous in T (bf16 or
// float32); B and C are [B, L, 16] with any batch and token strides and unit
// stride over the state (the slices of x_proj's output); A_log [E, 16], D
// and b_dt [E] are float32. Arithmetic is float32; exp(ΔA) is ex2.approx of
// Δ·log2(e)·A on the special-function unit.
//
// A block of 64 threads takes 64 channels of one row; the tokens go in
// chunks of 4 (the backward keeps a chunk's states in shared memory). For
// each chunk the block stages B and C, and each thread its tokens' Δ, Δu and
// the like, in shared memory, and the chunk's inputs are read from device
// memory one chunk ahead, so their latency falls under the last chunk's
// arithmetic. The forward runs the bwd direction first,
// keeping its y in ysum (float32, [B, L, E]), then the fwd direction, which
// writes ysum = y_fwd + y_bwd (the backward's dz reads it) and the gated
// mean.
//
// The backward (grid z: the direction) recomputes the states rather than
// reading saved ones: a first pass in the direction's order writes the state
// at each chunk's start (ckpt, float32 scratch); then, chunk by chunk in
// reverse, it recomputes the chunk's states into shared memory (with each
// token's dC) and runs the adjoint g_t = C_t dy_t + exp(Δ_{t+1} A) ⊙ g_{t+1}
// back through them (with each token's dB; exp(Δ_t A)·h_{t−1} is taken as
// h_t − Δ_t u_t B_t). dB_t and dC_t sum over channels: a warp sums its
// lanes' 16 values by halving exchanges (lane l ends with value l % 16), the
// block sums its warps in order and writes a partial a block of channels;
// dA_log, dD and db_dt sum over tokens in each thread and are written a
// row. The wrapper sums the partials over blocks and rows in a fixed order:
// no atomics, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;              // states a channel (d_state)
constexpr int kCH = 64;             // channels a block, one thread each
constexpr int kT = 4;               // tokens a chunk
constexpr int kWarps = kCH / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kErrArgs = -1;

// slots of the pointer table the entries take (ops/selective_scan.py: _INPUTS
// and the outputs and scratch after them)
enum Slot {
  kUf, kUb, kDrF, kDrB, kBf, kCf, kBb, kCb, kZ,
  kAlogF, kAlogB, kDF, kDB, kBdtF, kBdtB,
  kYsum, kOut,                                      // forward's outputs
  kDout = kOut, kDuF, kDuB, kDdrF, kDdrB, kDz,       // backward
  kCkpt, kPbc, kPa, kPd, kPb, kSlots
};

struct Dir {
  const void *u, *dr, *B, *C;
  long long b_sb, b_st, c_sb, c_st;   // B's and C's batch and token strides
  const float *a_log, *d, *bdt;
  void *du, *ddr;
};

struct Args {
  Dir dir[2];                         // 0: fwd, 1: bwd
  const void* z;
  const void* dout;
  float* ysum;
  void* out;
  void* dz;
  float *ckpt, *pbc, *pa, *pd, *pb;
  int batch, len, width;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 2^x on the special-function unit (relative error ~2^-22, a result below
// 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Δ = softplus(x) (torch's: beta 1, threshold 20) and softplus'(x) = σ(x),
// from one exp
__device__ __forceinline__ void softplus(float x, float& sp, float& sig) {
  const float ex = expf(x);
  sp = x > 20.f ? x : log1pf(ex);
  sig = x > 20.f ? 1.f : __fdividef(ex, 1.f + ex);
}
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + expf(-x)); }

__device__ __forceinline__ int token(int dir, int s, int len) { return dir ? len - 1 - s : s; }

// v[i] summed over the warp's lanes for i = lane & 15 (lanes l and l ^ 16
// end with the same sum): four halving exchanges and one more, 16 shuffles
// a lane, the same order on every call.
__device__ __forceinline__ float transpose_sum(float (&v)[kN], int lane) {
#pragma unroll
  for (int k = kN / 2; k >= 1; k >>= 1) {
    const bool upper = lane & k;
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const float send = upper ? v[i] : v[i + k];
      const float keep = upper ? v[i + k] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, k);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
}

constexpr int kBC = (kT * 2 * kN + kCH - 1) / kCH;   // B, C values a thread stages a chunk

// This thread's share of a chunk's B and C rows (tokens s0.. in the
// direction's order), read ahead into registers: value i = tid + q·kCH is
// token i / 32's B (i % 32 < 16) or C.
template <typename T>
__device__ __forceinline__ void load_bc(float (&r)[kBC], const Dir& d, int dir, int b, int s0,
                                        int n, int len) {
  const T* Bp = static_cast<const T*>(d.B) + b * d.b_sb;
  const T* Cp = static_cast<const T*>(d.C) + b * d.c_sb;
#pragma unroll
  for (int q = 0; q < kBC; ++q) {
    const int i = threadIdx.x + q * kCH, j = i / (2 * kN), k = i % (2 * kN);
    r[q] = 0.f;
    if (i < n * 2 * kN) {
      const long long t = token(dir, s0 + j, len);
      r[q] = k < kN ? load(Bp + t * d.b_st + k) : load(Cp + t * d.c_st + (k - kN));
    }
  }
}

// ... and into shared memory, as float32: bc[j][0..15] B, bc[j][16..31] C.
__device__ __forceinline__ void store_bc(float (*bc)[2 * kN], const float (&r)[kBC], int n) {
#pragma unroll
  for (int q = 0; q < kBC; ++q) {
    const int i = threadIdx.x + q * kCH;
    if (i < n * 2 * kN) bc[i / (2 * kN)][i % (2 * kN)] = r[q];
  }
}

// A thread's per-token inputs of a chunk, read ahead into registers.
template <typename T>
__device__ __forceinline__ void load_tokens(float (&r)[kT], const T* p, int dir, int s0, int n,
                                            int len, int E) {
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    r[j] = 0.f;
    if (j < n) r[j] = load(p + static_cast<long long>(token(dir, s0 + j, len)) * E);
  }
}

// Each chunk's inputs are read one chunk ahead: the loads for chunk c + 1
// are issued before chunk c's arithmetic and consumed after it.

template <typename T>
__global__ void __launch_bounds__(kCH) sedx_ss_forward_kernel(const Args a) {
  __shared__ __align__(16) float bc[kT][2 * kN];
  __shared__ float sc[kT][5][kCH];            // a token's Δ·log2 e, Δu, D·u, silu(z)/2, y_bwd
  const int tid = threadIdx.x, e = blockIdx.x * kCH + tid, b = blockIdx.y;
  const int L = a.len, E = a.width;
  const long long row = static_cast<long long>(b) * L * E + e;
  float* ys = a.ysum + row;
  const T* z = static_cast<const T*>(a.z) + row;
  T* out = static_cast<T*>(a.out) + row;
#pragma unroll 1
  for (int dir = 1; dir >= 0; --dir) {
    const Dir& d = a.dir[dir];
    const T* u = static_cast<const T*>(d.u) + row;
    const T* dr = static_cast<const T*>(d.dr) + row;
    float A[kN], h[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      A[n] = -expf(d.a_log[e * kN + n]);
      h[n] = 0.f;
    }
    const float D = d.d[e], bdt = d.bdt[e];
    float ru[kT], rd[kT], rz[kT], ry[kT], rbc[kBC];
    auto fetch = [&](int s0) {
      const int n = min(kT, L - s0);
      load_bc<T>(rbc, d, dir, b, s0, n, L);
      load_tokens(ru, u, dir, s0, n, L, E);
      load_tokens(rd, dr, dir, s0, n, L, E);
      if (!dir) {
        load_tokens(rz, z, dir, s0, n, L, E);
        load_tokens(ry, static_cast<const float*>(ys), dir, s0, n, L, E);
      }
    };
    fetch(0);
#pragma unroll 1
    for (int s0 = 0; s0 < L; s0 += kT) {
      const int n_tok = min(kT, L - s0);
      __syncthreads();                        // the last chunk's rows are read
      store_bc(bc, rbc, n_tok);
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        if (j < n_tok) {
          float delta, sig;
          softplus(rd[j] + bdt, delta, sig);
          sc[j][0][tid] = delta * kLog2e;
          sc[j][1][tid] = delta * ru[j];
          sc[j][2][tid] = D * ru[j];
          if (!dir) {
            sc[j][3][tid] = rz[j] * sigmoid(rz[j]) * 0.5f;
            sc[j][4][tid] = ry[j];
          }
        }
      }
      __syncthreads();
      if (s0 + kT < L) fetch(s0 + kT);
#pragma unroll 1
      for (int j = 0; j < n_tok; ++j) {
        const long long t = token(dir, s0 + j, L);
        const float dl = sc[j][0][tid], du = sc[j][1][tid];
        float y0 = sc[j][2][tid], y1 = 0.f;
#pragma unroll
        for (int n = 0; n < kN; n += 2) {
          h[n] = fmaf(ex2(dl * A[n]), h[n], du * bc[j][n]);
          h[n + 1] = fmaf(ex2(dl * A[n + 1]), h[n + 1], du * bc[j][n + 1]);
          y0 = fmaf(bc[j][kN + n], h[n], y0);
          y1 = fmaf(bc[j][kN + n + 1], h[n + 1], y1);
        }
        if (dir) {
          ys[t * E] = y0 + y1;
        } else {
          const float s = y0 + y1 + sc[j][4][tid];
          ys[t * E] = s;
          store(out + t * E, s * sc[j][3][tid]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCH) sedx_ss_backward_kernel(const Args a) {
  __shared__ __align__(16) float bc[kT][2 * kN];
  __shared__ float sc[kT][5][kCH];            // a token's Δ·log2 e, Δu, dy, σ(Δraw + b), u
  __shared__ float hs[kT][kN][kCH];           // the chunk's states, a thread's own column
  __shared__ float red[kT][kWarps][2 * kN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x * kCH + tid, b = blockIdx.y, dir = blockIdx.z;
  const int L = a.len, E = a.width, G = gridDim.x;
  const int chunks = (L + kT - 1) / kT;
  const long long row = static_cast<long long>(b) * L * E + e;
  const long long rank = static_cast<long long>(dir) * a.batch + b;   // (direction, row)
  const Dir& d = a.dir[dir];
  const T* u = static_cast<const T*>(d.u) + row;
  const T* dr = static_cast<const T*>(d.dr) + row;
  const T* z = static_cast<const T*>(a.z) + row;
  const T* dout = static_cast<const T*>(a.dout) + row;
  const float* ys = a.ysum + row;
  T* du_out = static_cast<T*>(d.du) + row;
  T* ddr_out = static_cast<T*>(d.ddr) + row;
  T* dz_out = static_cast<T*>(a.dz) + row;
  float* ck = a.ckpt + rank * chunks * kN * E + e;

  float A[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    A[n] = -expf(d.a_log[e * kN + n]);
    h[n] = 0.f;
  }
  const float D = d.d[e], bdt = d.bdt[e];
  float ru[kT], rd[kT], rbc[kBC];

  // pass 1: the state at each chunk's start
  load_bc<T>(rbc, d, dir, b, 0, min(kT, L), L);
  load_tokens(ru, u, dir, 0, min(kT, L), L, E);
  load_tokens(rd, dr, dir, 0, min(kT, L), L, E);
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const int s0 = c * kT, n_tok = min(kT, L - s0);
#pragma unroll
    for (int n = 0; n < kN; ++n) ck[(static_cast<long long>(c) * kN + n) * E] = h[n];
    __syncthreads();
    store_bc(bc, rbc, n_tok);
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < n_tok) {
        float delta, sig;
        softplus(rd[j] + bdt, delta, sig);
        sc[j][0][tid] = delta * kLog2e;
        sc[j][1][tid] = delta * ru[j];
      }
    }
    __syncthreads();
    if (c + 1 < chunks) {
      const int n = min(kT, L - s0 - kT);
      load_bc<T>(rbc, d, dir, b, s0 + kT, n, L);
      load_tokens(ru, u, dir, s0 + kT, n, L, E);
      load_tokens(rd, dr, dir, s0 + kT, n, L, E);
    }
#pragma unroll 1
    for (int j = 0; j < n_tok; ++j) {
      const float dl = sc[j][0][tid], du = sc[j][1][tid];
#pragma unroll
      for (int n = 0; n < kN; ++n) h[n] = fmaf(ex2(dl * A[n]), h[n], du * bc[j][n]);
    }
  }

  // pass 2: chunks in reverse, the states recomputed (with each token's dC),
  // then the adjoint back through them (with its dB)
  float g[kN], dA[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) g[n] = dA[n] = 0.f;
  float dD = 0.f, db = 0.f;
  float rz[kT], rg[kT], ry[kT];
  auto fetch = [&](int c) {
    const int s0 = c * kT, n = min(kT, L - s0);
    load_bc<T>(rbc, d, dir, b, s0, n, L);
    load_tokens(ru, u, dir, s0, n, L, E);
    load_tokens(rd, dr, dir, s0, n, L, E);
    load_tokens(rz, z, dir, s0, n, L, E);
    load_tokens(rg, dout, dir, s0, n, L, E);
    if (!dir) load_tokens(ry, ys, dir, s0, n, L, E);
  };
  fetch(chunks - 1);
#pragma unroll 1
  for (int c = chunks - 1; c >= 0; --c) {
    const int s0 = c * kT, n_tok = min(kT, L - s0);
#pragma unroll
    for (int n = 0; n < kN; ++n) h[n] = ck[(static_cast<long long>(c) * kN + n) * E];
    __syncthreads();                          // the last chunk's bc, sc and red are read
    store_bc(bc, rbc, n_tok);
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < n_tok) {
        const float uv = ru[j], zv = rz[j], go = rg[j];
        float delta, sig;
        softplus(rd[j] + bdt, delta, sig);
        const float sz = sigmoid(zv);
        sc[j][0][tid] = delta * kLog2e;
        sc[j][1][tid] = delta * uv;
        sc[j][2][tid] = go * zv * sz * 0.5f;
        sc[j][3][tid] = sig;
        sc[j][4][tid] = uv;
        if (!dir) {
          const long long t = token(dir, s0 + j, L);
          store(dz_out + t * E, go * ry[j] * 0.5f * sz * (1.f + zv * (1.f - sz)));
        }
      }
    }
    __syncthreads();
    if (c > 0) fetch(c - 1);
#pragma unroll 1
    for (int j = 0; j < n_tok; ++j) {
      const float dl = sc[j][0][tid], du = sc[j][1][tid], dy = sc[j][2][tid];
      float v[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = fmaf(ex2(dl * A[n]), h[n], du * bc[j][n]);
        hs[j][n][tid] = h[n];
        v[n] = dy * h[n];                       // dC_t[n], this channel's share
      }
      const float s = transpose_sum(v, lane);
      if (lane >= kN) red[j][warp][lane] = s;
    }
#pragma unroll 1
    for (int j = n_tok - 1; j >= 0; --j) {
      const long long t = token(dir, s0 + j, L);
      const float dl = sc[j][0][tid], du = sc[j][1][tid], dy = sc[j][2][tid];
      const float uv = sc[j][4][tid];
      float sA = 0.f, sG = 0.f;
      float v[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float gn = fmaf(bc[j][kN + n], dy, g[n]);
        const float ah = fmaf(-du, bc[j][n], hs[j][n][tid]);   // exp(ΔA)·h_{t−1}
        const float gah = gn * ah;
        sG = fmaf(gn, bc[j][n], sG);
        sA = fmaf(gah, A[n], sA);
        dA[n] = fmaf(gah, dl, dA[n]);           // × ln 2 at the end
        v[n] = gn * du;                         // dB_t[n], this channel's share
        g[n] = gn * ex2(dl * A[n]);
      }
      dD = fmaf(dy, uv, dD);
      const float ddr = fmaf(uv, sG, sA) * sc[j][3][tid];
      db += ddr;
      store(du_out + t * E, fmaf(dl * kLn2, sG, D * dy));
      store(ddr_out + t * E, ddr);
      const float s = transpose_sum(v, lane);
      if (lane < kN) red[j][warp][lane] = s;
    }
    __syncthreads();
    for (int i = tid; i < n_tok * 2 * kN; i += kCH) {
      const int j = i / (2 * kN), k = i % (2 * kN);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[j][w][k];
      const long long t = token(dir, s0 + j, L);
      a.pbc[((rank * L + t) * G + blockIdx.x) * (2 * kN) + k] = s;
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) a.pa[(rank * kN + n) * E + e] = dA[n] * kLn2 * A[n];
  a.pd[rank * E + e] = dD;
  a.pb[rank * E + e] = db;
}

Args make_args(const void* const* p, const long long* st, int batch, int len, int width) {
  Args a{};
  for (int dir = 0; dir < 2; ++dir) {
    Dir& d = a.dir[dir];
    d.u = p[dir ? kUb : kUf];
    d.dr = p[dir ? kDrB : kDrF];
    d.B = p[dir ? kBb : kBf];
    d.C = p[dir ? kCb : kCf];
    d.b_sb = st[4 * dir + 0];
    d.b_st = st[4 * dir + 1];
    d.c_sb = st[4 * dir + 2];
    d.c_st = st[4 * dir + 3];
    d.a_log = static_cast<const float*>(p[dir ? kAlogB : kAlogF]);
    d.d = static_cast<const float*>(p[dir ? kDB : kDF]);
    d.bdt = static_cast<const float*>(p[dir ? kBdtB : kBdtF]);
  }
  a.z = p[kZ];
  a.ysum = static_cast<float*>(const_cast<void*>(p[kYsum]));
  a.batch = batch;
  a.len = len;
  a.width = width;
  return a;
}

bool bad_shape(int dtype, int batch, int len, int width) {
  return (dtype != 0 && dtype != 1) || batch < 1 || len < 1 || width < kCH ||
         width % kCH || batch > 65535;
}

}  // namespace

extern "C" {

const char* sedx_ss_error_string(int code) {
  if (code == kErrArgs) return "unsupported dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sedx_ss_chunk_tokens() { return kT; }
int sedx_ss_block_channels() { return kCH; }

// p: the pointer table (Slot, forward's slots); st: the batch and token
// strides of B_fwd, C_fwd, B_bwd, C_bwd (elements); dtype 0 float32, 1 bf16.
int sedx_ss_forward(int dtype, const void* const* p, const long long* st, int batch, int len,
                    int width, void* stream) {
  if (bad_shape(dtype, batch, len, width)) return kErrArgs;
  Args a = make_args(p, st, batch, len, width);
  a.out = const_cast<void*>(p[kOut]);
  const dim3 grid(width / kCH, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    sedx_ss_forward_kernel<__nv_bfloat16><<<grid, kCH, 0, s>>>(a);
  else
    sedx_ss_forward_kernel<float><<<grid, kCH, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward's slots; ckpt [2, B, ⌈L/4⌉, 16, E], pbc [2, B, L, E/64, 32],
// pa [2, B, 16, E], pd and pb [2, B, E], all float32 scratch.
int sedx_ss_backward(int dtype, const void* const* p, const long long* st, int batch, int len,
                     int width, void* stream) {
  if (bad_shape(dtype, batch, len, width)) return kErrArgs;
  Args a = make_args(p, st, batch, len, width);
  a.dout = p[kDout];
  a.dir[0].du = const_cast<void*>(p[kDuF]);
  a.dir[1].du = const_cast<void*>(p[kDuB]);
  a.dir[0].ddr = const_cast<void*>(p[kDdrF]);
  a.dir[1].ddr = const_cast<void*>(p[kDdrB]);
  a.dz = const_cast<void*>(p[kDz]);
  a.ckpt = static_cast<float*>(const_cast<void*>(p[kCkpt]));
  a.pbc = static_cast<float*>(const_cast<void*>(p[kPbc]));
  a.pa = static_cast<float*>(const_cast<void*>(p[kPa]));
  a.pd = static_cast<float*>(const_cast<void*>(p[kPd]));
  a.pb = static_cast<float*>(const_cast<void*>(p[kPb]));
  const dim3 grid(width / kCH, batch, 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    sedx_ss_backward_kernel<__nv_bfloat16><<<grid, kCH, 0, s>>>(a);
  else
    sedx_ss_backward_kernel<float><<<grid, kCH, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
