// Fused log-mel frontend for Hopper (sm_90a): padded clip rows -> log-mel,
// by a mixed-radix FFT in shared memory.
//
// Replaces two Pallas TPU kernels of
// sound_event_detection_dcase2017_task4_tpu/ops/pallas_logmel.py (one body,
// `_kernel`, in both):
//   * pallas_logmel.py:logmel_pallas — a batch of waveforms, reflect-padded
//     by the wrapper (entry sedx_logmel_launch: float rows, no index);
//   * pallas_logmel.py:logmel_pallas_bank — rows idx[b] gathered from a
//     device-resident corpus bank staged as hop-chunk rows [N, n_rows, hop],
//     float32 or int16 (entry sedx_logmel_bank_launch).
// It computes what those kernels compute, not their TPU block structure:
//
//   frame f = the `win` samples starting at f*hop of the centre-padded clip
//   out     = 10*log10(max(amin, |rfft(frame * hann)|^2[:n_used] @ melW)) - ref_db
//
// The TPU kernels run the DFT as a GEMM against a [cos | sin] basis on the
// MXU. So did this file until it was redesigned: 1024 x 896 f32 FMAs a
// frame on the CUDA cores (242 GFLOP for a training batch of 128 clips),
// 8.30 ms for those 128 int16 rows and 1.14 ms for 16 waveforms on an H100
// (chip_smoke.py; PERF.md), 3.7-4.1x slower than torch.stft.
//
// Design. A block owns TF frames of one clip. It loads the clip's span
// [f0*hop, (f0+TF-1)*hop + win) into shared memory once (16-byte vector
// loads where aligned; int16 converted to float at the store; samples past
// the row read as 0), so the 3.2x overlapped frames never re-read device
// memory. Each group of G threads takes one frame at a time: it packs the
// windowed even/odd samples into M = win/2 complex points, runs a Stockham
// autosort FFT of M points (stages of radix 8, 4, 2 written out; any other
// prime factor as a generic radix-p stage driven by a DFT table), ping-pong
// between two padded shared buffers, then the real split
//   Y[k] = (Z[k] + conj Z[M-k])/2 - i e^{-2 pi i k/win} (Z[k] - conj Z[M-k])/2
// and the power of the n_used bins the mel bank reads. The power of all TF
// frames stays in shared memory; the mel step sums each band over its
// contiguous range of non-zero bins (a Slaney bin feeds at most two bands),
// pairing band q with band mel-1-q so that the threads' loops are even.
// Frames, spectra and power never reach device memory; for a bank neither
// does the gathered batch nor its decoded float copy. Every twiddle,
// window value and mel weight comes from the host plan
// (ops/logmel_cuda.py:plan, float64 rounded to float32): no sin/cos here.
//
// Each frame is its own FFT (no two-for-one packing of two frames into one
// complex transform), so a bin's rounding error is relative to its own
// frame: a silent frame next to a loud one stays exactly 0 and gives
// exactly -100 dB.
//
// What bounds it: the function needs an FFT's ~21 kFLOP a frame, 2.65 GFLOP
// for 128 clips (0.040 ms at the card's 67 TFLOP/s f32) beside 82 MB of
// int16 in and 33 MB of log-mel out (0.034 ms at 3.35 TB/s): operations for
// a bank, bytes for 16 float waveforms. This design is bound by shared-
// memory traffic (each stage reads and writes M complex values, the split
// and the mel sums read the power again; the SM serves one wavefront a
// cycle) and by the barriers between stages. A variant that fit three
// blocks on an SM by reading the plan through L1 (the same data path) and
// summing the mel bands per frame ran slower. PERF.md has the measured
// shares.
//
// Precision: float32 for both "highest" and "fast" (the FFT's rounding is
// below that of the f32 GEMM it replaces). The int16 PCM scale (2^-15) is
// folded into the window table on the host, exact for a power of two:
// q*(w*s) == (q*s)*w, so the int16 launch is bit-equal to the float launch
// on the decoded rows. Both entries run the same non-inlined body.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC   (see ops/logmel_cuda.py)
// Bound through ctypes: plain C entry points below; each launch returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TF = 16;        // frames per block
constexpr int G = 64;         // threads per frame
constexpr int FI = 4;         // frames in flight per block
constexpr int NT = G * FI;    // threads per block

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// FFT buffer index with one pad slot every 16 complex values: keeps the
// Stockham stages' strided writes and the split's mirrored reads within
// two-way bank conflicts.
__host__ __device__ __forceinline__ int pad_idx(int j) { return j + (j >> 4); }

// The host plan, flattened (ops/logmel_cuda.py:_device_plan):
//   plan_f = [window (win) | twiddles (2*n_tw) | split twiddles (2*n_used)
//             | band weights (n_w)]
//   plan_i = [stages (4*n_stages: radix, p, twiddle offset, DFT table
//             offset) | bands (4*mel: lo, hi, weight offset, 0)]
struct Params {
  const float* plan_f;
  const int* plan_i;
  float* out;                  // [batch, n_frames, mel]
  int row_len, n_frames, win, hop, n_stages, n_tw, n_used, n_w, mel;
  float amin, ref_db;
};

// Shared-memory layout of a block, in floats (every region 16-byte aligned).
struct Layout {
  int span, plan_f, plan_i, buf, pow, mel, total;
  int buf_len;      // float2 per FFT buffer (even)
  int pow_stride;   // floats per frame of power (== 1 mod 32)
};

__host__ __device__ inline Layout make_layout(int win, int hop, int n_stages,
                                              int n_tw, int n_used, int n_w,
                                              int mel) {
  Layout L;
  const int m = win / 2;
  L.buf_len = (pad_idx(m - 1) + 2) & ~1;
  L.pow_stride = ((n_used + 31) & ~31) + 1;
  int o = 0;
  L.span = o;   o += round4((TF - 1) * hop + win);
  L.plan_f = o; o += round4(win + 2 * n_tw + 2 * n_used + n_w);
  L.plan_i = o; o += 4 * (n_stages + mel);
  L.buf = o;    o += FI * 2 * 2 * L.buf_len;
  L.pow = o;    o += round4(TF * L.pow_stride);
  L.mel = o;    o += TF * mel;
  L.total = o;
  return L;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_negi(float2 a) {   // a * (-i)
  return make_float2(a.y, -a.x);
}

// In-place forward DFTs (e^{-2 pi i r q / R}), outputs in natural order.
__device__ __forceinline__ void dft(float2 (&u)[2]) {
  const float2 t = u[0];
  u[0] = cadd(t, u[1]);
  u[1] = csub(t, u[1]);
}

__device__ __forceinline__ void dft(float2 (&u)[4]) {
  const float2 b0 = cadd(u[0], u[2]), b2 = csub(u[0], u[2]);
  const float2 b1 = cadd(u[1], u[3]), b3 = mul_negi(csub(u[1], u[3]));
  u[0] = cadd(b0, b1);
  u[2] = csub(b0, b1);
  u[1] = cadd(b2, b3);
  u[3] = csub(b2, b3);
}

__device__ __forceinline__ void dft(float2 (&u)[8]) {
  const float h = 0.70710678118654752f;   // sqrt(1/2)
  const float2 a0 = cadd(u[0], u[4]), a4 = csub(u[0], u[4]);
  const float2 a1 = cadd(u[1], u[5]), d5 = csub(u[1], u[5]);
  const float2 a2 = cadd(u[2], u[6]), d6 = csub(u[2], u[6]);
  const float2 a3 = cadd(u[3], u[7]), d7 = csub(u[3], u[7]);
  const float2 a5 = make_float2(h * (d5.x + d5.y), h * (d5.y - d5.x));   // e^{-i pi/4}
  const float2 a6 = mul_negi(d6);                                       // e^{-i pi/2}
  const float2 a7 = make_float2(h * (d7.y - d7.x), -h * (d7.x + d7.y)); // e^{-3i pi/4}
  const float2 b0 = cadd(a0, a2), b2 = csub(a0, a2);
  const float2 b1 = cadd(a1, a3), b3 = mul_negi(csub(a1, a3));
  const float2 b4 = cadd(a4, a6), b6 = csub(a4, a6);
  const float2 b5 = cadd(a5, a7), b7 = mul_negi(csub(a5, a7));
  u[0] = cadd(b0, b1);
  u[4] = csub(b0, b1);
  u[2] = cadd(b2, b3);
  u[6] = csub(b2, b3);
  u[1] = cadd(b4, b5);
  u[5] = csub(b4, b5);
  u[3] = cadd(b6, b7);
  u[7] = csub(b6, b7);
}

// Stage sources: the first stage reads the windowed frame straight from the
// span (complex point j = samples 2j, 2j+1); later stages read a buffer.
struct SpanSrc {
  const float* s;      // the frame's first sample in the span
  const float2* w;     // window pairs
  bool even;           // s is 8-byte aligned
  __device__ __forceinline__ float2 operator()(int j) const {
    float a, b;
    if (even) {
      const float2 v = reinterpret_cast<const float2*>(s)[j];
      a = v.x;
      b = v.y;
    } else {
      a = s[2 * j];
      b = s[2 * j + 1];
    }
    const float2 ww = w[j];
    return make_float2(__fmul_rn(a, ww.x), __fmul_rn(b, ww.y));
  }
};

struct BufSrc {
  const float2* b;
  __device__ __forceinline__ float2 operator()(int j) const { return b[pad_idx(j)]; }
};

// One Stockham stage of radix R (2, 4 or 8) over m points after stages
// whose radices multiply to p: butterfly i (k = i mod p) reads points
// i + r*m/R, multiplies them by e^{-2 pi i r k/(pR)} (tw[(r-1)*p + k]) and
// writes its outputs to (i-k)*R + k + q*p.
template <int R, class Src>
__device__ __forceinline__ void stage_pow2(const Src& src, float2* dst,
                                           const float2* tw, int m, int p,
                                           int g) {
  const int nb = m / R;
  for (int i = g; i < nb; i += G) {
    const int k = i & (p - 1);   // p is a power of two: these stages come first
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = src(i + r * nb);
    if (p > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) u[r] = cmul(u[r], tw[(r - 1) * p + k]);
    }
    dft(u);
    const int j = (i - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad_idx(j + r * p)] = u[r];
  }
}

// A stage of any other radix: one thread per output (butterfly i, output
// q), a direct DFT against the table dtab[j] = e^{-2 pi i j/R}.
template <class Src>
__device__ void stage_generic(const Src& src, float2* dst, const float2* tw,
                              const float2* dtab, int m, int R, int p, int g) {
  const int nb = m / R;
  for (int it = g; it < m; it += G) {
    const int q = it / nb, i = it - q * nb;
    const int k = i % p;
    float2 acc = src(i);
    int e = 0;
    for (int r = 1; r < R; ++r) {
      float2 v = src(i + r * nb);
      if (p > 1) v = cmul(v, tw[(r - 1) * p + k]);
      e += q;
      if (e >= R) e -= R;
      acc = cadd(acc, cmul(v, dtab[e]));
    }
    dst[pad_idx((i - k) * R + k + q * p)] = acc;
  }
}

template <class Src>
__device__ __forceinline__ void run_stage(const Src& src, float2* dst,
                                          const int4 st, const float2* tw,
                                          int m, int g) {
  switch (st.x) {
    case 8: stage_pow2<8>(src, dst, tw + st.z, m, st.y, g); break;
    case 4: stage_pow2<4>(src, dst, tw + st.z, m, st.y, g); break;
    case 2: stage_pow2<2>(src, dst, tw + st.z, m, st.y, g); break;
    default: stage_generic(src, dst, tw + st.z, tw + st.w, m, st.x, st.y, g);
  }
}

// Barrier of the G threads of frame group grp (named barriers 1..FI; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(G) : "memory");
}

// Everything after the span load, shared by both sample types (not inlined:
// the int16 and float entries run the same machine code on the same span).
__device__ __noinline__ void logmel_body(float* smem, const Params P, int b,
                                         int f0) {
  const Layout L = make_layout(P.win, P.hop, P.n_stages, P.n_tw, P.n_used,
                               P.n_w, P.mel);
  const int tid = threadIdx.x;
  float* s_f = smem + L.plan_f;
  int* s_i = reinterpret_cast<int*>(smem + L.plan_i);
  const int nf = P.win + 2 * P.n_tw + 2 * P.n_used + P.n_w;
  for (int i = tid; i < nf; i += NT) s_f[i] = __ldg(P.plan_f + i);
  for (int i = tid; i < 4 * (P.n_stages + P.mel); i += NT) s_i[i] = __ldg(P.plan_i + i);
  __syncthreads();   // the span (loaded by the caller) and the plan

  const float* s_span = smem + L.span;
  const float2* s_win = reinterpret_cast<const float2*>(s_f);
  const float2* s_tw = reinterpret_cast<const float2*>(s_f + P.win);
  const float2* s_split = s_tw + P.n_tw;
  const float* s_bw = reinterpret_cast<const float*>(s_split + P.n_used);
  const int4* s_stage = reinterpret_cast<const int4*>(s_i);
  const int4* s_band = s_stage + P.n_stages;
  float* s_pow = smem + L.pow;
  float* s_mel = smem + L.mel;

  const int m = P.win / 2;
  const int grp = tid / G, g = tid % G;
  float2* buf0 = reinterpret_cast<float2*>(smem + L.buf) + grp * 2 * L.buf_len;
  float2* buf1 = buf0 + L.buf_len;

  for (int r0 = 0; r0 < TF; r0 += FI) {
    const int f = r0 + grp;
    const int off = f * P.hop;
    const SpanSrc first{s_span + off, s_win, (off & 1) == 0};
    run_stage(first, buf0, s_stage[0], s_tw, m, g);
    group_sync(grp);
    float2* cur = buf0;
    float2* nxt = buf1;
    for (int s = 1; s < P.n_stages; ++s) {
      run_stage(BufSrc{cur}, nxt, s_stage[s], s_tw, m, g);
      group_sync(grp);
      float2* t = cur;
      cur = nxt;
      nxt = t;
    }
    // real split: the spectrum of the 2m real samples from the m-point one
    float* pw = s_pow + f * L.pow_stride;
    for (int k = g; k < P.n_used; k += G) {
      const float2 a = cur[pad_idx(k == m ? 0 : k)];
      const float2 c = cur[pad_idx(k == 0 ? 0 : m - k)];
      const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
      const float2 o = mul_negi(make_float2(0.5f * (a.x - c.x), 0.5f * (a.y + c.y)));
      const float2 y = cadd(e, cmul(s_split[k], o));
      pw[k] = y.x * y.x + y.y * y.y;
    }
    group_sync(grp);   // the group's buffers are free for its next frame
  }
  __syncthreads();

  // Mel bands: task (pair q, frame f) sums band q and band mel-1-q of frame
  // f; neighbouring threads take neighbouring frames of one pair.
  const int n_pairs = (P.mel + 1) / 2;
  for (int i = tid; i < n_pairs * TF; i += NT) {
    const int q = i / TF, f = i - q * TF;
    const float* pw = s_pow + f * L.pow_stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int band = h == 0 ? q : P.mel - 1 - q;
      if (h == 1 && band == q) break;
      const int4 bd = s_band[band];
      const float* w = s_bw + bd.z - bd.x;
      float acc = 0.f;
      for (int k = bd.x; k < bd.y; ++k) acc = fmaf(pw[k], w[k], acc);
      s_mel[f * P.mel + band] = acc;
    }
  }
  __syncthreads();

  // Epilogue: log compression; the ragged last tile writes only real frames.
  // log10 in double so that the amin floor comes out exact (-100 dB at the
  // default amin = 1e-10), as the float32 reference rounds it.
  for (int i = tid; i < TF * P.mel; i += NT) {
    const int f = i / P.mel, mb = i - f * P.mel;
    if (f0 + f < P.n_frames) {
      const float v = s_mel[i];
      const float c = (v != v) ? v : fmaxf(P.amin, v);   // NaN propagates
      P.out[(static_cast<long long>(b) * P.n_frames + f0 + f) * P.mel + mb] =
          static_cast<float>(10.0 * log10(static_cast<double>(c))) - P.ref_db;
    }
  }
}

__device__ __forceinline__ void store_converted(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void store_converted(float* dst, int4 v) {
  // eight int16 samples, little-endian pairs in each 32-bit word
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4 o;
    o.x = static_cast<float>(static_cast<int16_t>(w[2 * h] & 0xffff));
    o.y = static_cast<float>(static_cast<int16_t>(w[2 * h] >> 16));
    o.z = static_cast<float>(static_cast<int16_t>(w[2 * h + 1] & 0xffff));
    o.w = static_cast<float>(static_cast<int16_t>(w[2 * h + 1] >> 16));
    *reinterpret_cast<float4*>(dst + 4 * h) = o;
  }
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<int16_t> { using type = int4; };

// T is the sample type (float, or int16_t for a quantised bank). Clip b is
// row idx[b] of `rows` (row b when idx is null); a row holds row_len samples,
// the centre-padded clip and, for a staged bank, its zero tail.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
logmel_kernel(const T* __restrict__ rows, const int* __restrict__ idx,
              const Params P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * TF;
  const int row = idx != nullptr ? __ldg(idx + b) : b;
  const long long start = static_cast<long long>(f0) * P.hop;
  const T* src = rows + static_cast<long long>(row) * P.row_len + start;
  // the span of the block's frames; samples past the row read as 0 (they
  // belong to frames past n_frames, which are never written)
  float* span = smem;   // Layout.span == 0
  const int len = (TF - 1) * P.hop + P.win;
  const long long left = P.row_len - start;
  const int avail = left < len ? static_cast<int>(left) : len;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  using VecT = typename Vec16<T>::type;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = avail / V;
    const VecT* s16 = reinterpret_cast<const VecT*>(src);
    for (int v = threadIdx.x; v < nv; v += NT) store_converted(span + v * V, __ldg(s16 + v));
    done = nv * V;
  }
  for (int i = done + static_cast<int>(threadIdx.x); i < len; i += NT)
    span[i] = i < avail ? static_cast<float>(__ldg(src + i)) : 0.f;
  logmel_body(smem, P, b, f0);
}

int shared_bytes(int win, int hop, int n_stages, int n_tw, int n_used,
                 int n_w, int mel) {
  return make_layout(win, hop, n_stages, n_tw, n_used, n_w, mel).total *
         static_cast<int>(sizeof(float));
}

// Lets logmel_kernel<T> take `smem` bytes of dynamic shared memory, with
// the SM's split of L1 and shared memory favouring the latter.
template <typename T>
cudaError_t allow_shared(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(logmel_kernel<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const T* rows, const int* idx, const Params& P, int batch,
           void* stream) {
  if (P.win < 4 || P.win % 2 != 0 || P.n_stages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(P.win, P.hop, P.n_stages, P.n_tw, P.n_used,
                                P.n_w, P.mel);
  const cudaError_t err = allow_shared<T>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (P.n_frames + TF - 1) / TF);
  logmel_kernel<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, idx, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int smem) {
  int n = 0;
  cudaError_t err = allow_shared<T>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, logmel_kernel<T>,
                                                        NT, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

Params make_params(const void* plan_f, const void* plan_i, void* out,
                   int row_len, int n_frames, int win, int hop, int n_stages,
                   int n_tw, int n_used, int n_w, int mel_bins, float amin,
                   float ref_db) {
  return Params{static_cast<const float*>(plan_f),
                static_cast<const int*>(plan_i), static_cast<float*>(out),
                row_len, n_frames, win, hop, n_stages, n_tw, n_used, n_w,
                mel_bins, amin, ref_db};
}

}  // namespace

extern "C" {

// The host plan (ops/logmel_cuda.py) assumes these.
int sedx_logmel_frames_per_block() { return TF; }
int sedx_logmel_threads_per_frame() { return G; }
int sedx_logmel_frames_in_flight() { return FI; }

// Dynamic shared memory of one block, in bytes.
int sedx_logmel_shared_bytes(int win, int hop, int n_stages, int n_tw,
                             int n_used, int n_w, int mel_bins) {
  return shared_bytes(win, hop, n_stages, n_tw, n_used, n_w, mel_bins);
}

// Blocks of the kernel for samples of sample_bytes (4: float, 2: int16)
// that fit on one SM at once, or minus a CUDA error code.
int sedx_logmel_blocks_per_sm(int win, int hop, int n_stages, int n_tw,
                              int n_used, int n_w, int mel_bins,
                              int sample_bytes) {
  const int smem = shared_bytes(win, hop, n_stages, n_tw, n_used, n_w,
                                mel_bins);
  return sample_bytes == 2 ? blocks_per_sm<int16_t>(smem)
                           : blocks_per_sm<float>(smem);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an odd window.
int sedx_logmel_launch(const void* xpad, const void* plan_f,
                       const void* plan_i, void* out, int batch,
                       int padded_len, int n_frames, int win, int hop,
                       int n_stages, int n_tw, int n_used, int n_w,
                       int mel_bins, float amin, float ref_db, void* stream) {
  const Params P = make_params(plan_f, plan_i, out, padded_len, n_frames, win,
                               hop, n_stages, n_tw, n_used, n_w, mel_bins,
                               amin, ref_db);
  return launch(static_cast<const float*>(xpad), nullptr, P, batch, stream);
}

// The bank entry: `bank` holds rows of row_len samples of sample_bytes each
// (4: float, 2: int16); clip b is row idx[b] (every row in order when idx is
// null). Returns cudaGetLastError(), or cudaErrorInvalidValue for another
// sample size or an odd window.
int sedx_logmel_bank_launch(const void* bank, int sample_bytes,
                            const void* idx, const void* plan_f,
                            const void* plan_i, void* out, int batch,
                            int row_len, int n_frames, int win, int hop,
                            int n_stages, int n_tw, int n_used, int n_w,
                            int mel_bins, float amin, float ref_db,
                            void* stream) {
  const int* index = static_cast<const int*>(idx);
  const Params P = make_params(plan_f, plan_i, out, row_len, n_frames, win,
                               hop, n_stages, n_tw, n_used, n_w, mel_bins,
                               amin, ref_db);
  if (sample_bytes == 4)
    return launch(static_cast<const float*>(bank), index, P, batch, stream);
  if (sample_bytes == 2)
    return launch(static_cast<const int16_t*>(bank), index, P, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sedx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
