// Fused log-mel frontend for Hopper (sm_90a): padded clip rows -> log-mel.
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
//   frame f   = the `win` samples starting at f*hop of the centre-padded clip
//   [Re | Im] = frame @ [Wcos | Wsin]       (Hann window folded into the basis,
//                                            bins trimmed to those the mel
//                                            bank reads: 448 at the DCASE config)
//   out       = 10*log10(max(amin, (Re^2 + Im^2) @ melW)) - ref_db
//
// The TPU kernels' hop-chunk staging and 128-lane padding exist only for
// Mosaic; here a frame is a pointer offset f*hop into the padded clip, K =
// win, and bins are padded only to this kernel's pass width (BN). A staged
// bank row read flat IS the centre-padded clip followed by a zero tail, so
// the in-kernel gather is one more pointer offset, idx[b]*row_len, which the
// block loads itself (the TPU kernel's scalar-prefetched index map). An
// int16 sample is converted to float as it is stored into shared memory;
// its PCM scale (2^-15) is folded into the basis on the host, which is exact
// (a power of two, and no scaled basis value underflows): q*(c*s) == (q*s)*c,
// so the int16 launch is bit-equal to the float launch on the decoded rows.
//
// What bounds it: operations, for this algorithm. At the DCASE config one
// clip needs 2*1001*(1024*896 + 448*64) = 1.894 GFLOP (242.5 GFLOP for a
// training batch of 128) against ~1.3 MB of float waveform (0.64 MB as
// int16), far above the card's FLOP/byte balance point. The function needs
// far less: an FFT's ~21 kFLOP per frame, 2.65 GFLOP for 128 clips, ~0.04 ms
// at the f32 peak beside ~0.035 ms for its 82 MB of int16 and 33 MB of
// output; see flops_and_bytes in ops/logmel_cuda.py. Design answer: neither
// the frame matrix nor the power spectrogram ever reaches device memory, and
// for a bank neither does the gathered batch nor its decoded float copy (the
// point of the TPU kernels too). A block owns TF frames of one clip; it walks
// the bins in passes of BN, and for each pass streams the basis through
// shared memory in KT-row tiles while its frame rows come straight from the
// clip row; the pass's power goes to shared memory and is projected onto the
// mel bank at once, so only [TF, mel] sums live across passes. Each thread
// keeps a 4-frame x 4-bin (Re, Im) register tile.
//
// Precision: float32 FMA on the CUDA cores for both "highest" and "fast".
// ("fast" is a single bf16 pass on the TPU; here it computes the same as
// "highest" until a TF32/bf16 wgmma path exists.)
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC   (see ops/logmel_cuda.py)
// Bound through ctypes: plain C entry points below; each launch returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TF = 32;        // frames per block
constexpr int BN = 64;        // frequency bins per pass (basis is padded to it)
constexpr int KT = 32;        // window samples per shared basis/frame tile
constexpr int NT = 128;       // threads: 8 frame groups x 16 bin groups
constexpr int FSTRIDE = KT + 1;   // frame-tile row stride (no bank conflicts)

// shared-memory layout, in floats (every offset a multiple of 4 -> float4 ok)
constexpr int S_BASIS = 0;                      // [KT][2*BN]  cos | sin
constexpr int S_POWER = S_BASIS + KT * 2 * BN;  // [TF][BN]
constexpr int S_FRAMES = S_POWER + TF * BN;     // [TF][FSTRIDE]
constexpr int S_MEL = S_FRAMES + ((TF * FSTRIDE + 3) / 4) * 4;  // [TF][mel]

// T is the sample type (float, or int16_t for a quantised bank). Clip b is
// row idx[b] of `rows` (row b when idx is null); a row holds row_len samples,
// the centre-padded clip and, for a staged bank, its zero tail.
template <typename T>
__global__ void __launch_bounds__(NT)
logmel_kernel(const T* __restrict__ rows,        // [n_rows_total, row_len]
              const int* __restrict__ idx,       // [batch] or null
              const float* __restrict__ basis,   // [n_pass, k_pad, 2*BN]
              const float* __restrict__ melw,    // [n_pass*BN, mel_bins]
              float* __restrict__ out,           // [batch, n_frames, mel_bins]
              int row_len, int n_frames, int hop, int k_pad, int n_pass,
              int mel_bins, float amin, float ref_db) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_basis = smem + S_BASIS;
  float* s_power = smem + S_POWER;
  float* s_frames = smem + S_FRAMES;
  float* s_mel = smem + S_MEL;

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // bins  tx*4 .. tx*4+3 of the pass
  const int ty = tid / 16;          // frames ty*4 .. ty*4+3 of the tile
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * TF;
  const int row = idx != nullptr ? __ldg(idx + b) : b;
  const T* clip = rows + static_cast<long long>(row) * row_len;
  const long long tile_start = static_cast<long long>(f0) * hop;

  for (int i = tid; i < TF * mel_bins; i += NT) s_mel[i] = 0.f;

  for (int p = 0; p < n_pass; ++p) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    const float4* basis_p = reinterpret_cast<const float4*>(
        basis + static_cast<long long>(p) * k_pad * 2 * BN);
    for (int k0 = 0; k0 < k_pad; k0 += KT) {
      __syncthreads();  // every thread is done with the previous tiles
      const float4* src = basis_p + static_cast<long long>(k0) * (2 * BN / 4);
      float4* dst = reinterpret_cast<float4*>(s_basis);
#pragma unroll
      for (int i = tid; i < KT * 2 * BN / 4; i += NT) dst[i] = __ldg(src + i);
#pragma unroll
      for (int i = tid; i < TF * KT; i += NT) {
        const int f = i / KT, k = i % KT;
        const long long pos = tile_start + static_cast<long long>(f) * hop + k0 + k;
        // samples past the row belong to frames past n_frames (never
        // written) or meet zero basis rows (k >= win): load them as 0
        s_frames[f * FSTRIDE + k] =
            pos < row_len ? static_cast<float>(__ldg(clip + pos)) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        const float4 c = *reinterpret_cast<const float4*>(s_basis + kk * 2 * BN + tx * 4);
        const float4 s = *reinterpret_cast<const float4*>(s_basis + kk * 2 * BN + BN + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = s_frames[(ty * 4 + i) * FSTRIDE + kk];
          re[i][0] = fmaf(x, c.x, re[i][0]);
          re[i][1] = fmaf(x, c.y, re[i][1]);
          re[i][2] = fmaf(x, c.z, re[i][2]);
          re[i][3] = fmaf(x, c.w, re[i][3]);
          im[i][0] = fmaf(x, s.x, im[i][0]);
          im[i][1] = fmaf(x, s.y, im[i][1]);
          im[i][2] = fmaf(x, s.z, im[i][2]);
          im[i][3] = fmaf(x, s.w, im[i][3]);
        }
      }
    }

    // This pass's power -> shared. The previous pass's mel step has
    // finished reading s_power: every thread passed this pass's K-loop
    // barriers since.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v;
      v.x = re[i][0] * re[i][0] + im[i][0] * im[i][0];
      v.y = re[i][1] * re[i][1] + im[i][1] * im[i][1];
      v.z = re[i][2] * re[i][2] + im[i][2] * im[i][2];
      v.w = re[i][3] * re[i][3] + im[i][3] * im[i][3];
      *reinterpret_cast<float4*>(s_power + (ty * 4 + i) * BN + tx * 4) = v;
    }
    __syncthreads();

    // Project the pass's BN bins onto the mel bank. Each (frame, mel) sum
    // is owned by one thread across all passes, so s_mel needs no barrier.
    const float* melw_p = melw + static_cast<long long>(p) * BN * mel_bins;
    for (int i = tid; i < TF * mel_bins; i += NT) {
      const int f = i / mel_bins, m = i - f * mel_bins;
      const float* pw = s_power + f * BN;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < BN; ++k) acc = fmaf(pw[k], __ldg(melw_p + k * mel_bins + m), acc);
      s_mel[i] += acc;
    }
  }

  // Epilogue: log compression; the ragged last tile writes only real frames.
  // log10 in double so that the amin floor comes out exact (-100 dB at the
  // default amin = 1e-10), as the float32 reference rounds it.
  for (int i = tid; i < TF * mel_bins; i += NT) {
    const int f = i / mel_bins, m = i - f * mel_bins;
    if (f0 + f < n_frames) {
      const float v = s_mel[i];
      const float c = (v != v) ? v : fmaxf(amin, v);   // NaN propagates
      out[(static_cast<long long>(b) * n_frames + f0 + f) * mel_bins + m] =
          static_cast<float>(10.0 * log10(static_cast<double>(c))) - ref_db;
    }
  }
}

// Shared memory one block needs, in bytes.
int smem_bytes(int mel_bins) {
  return (S_MEL + TF * mel_bins) * static_cast<int>(sizeof(float));
}

template <typename T>
int launch(const T* rows, const int* idx, const void* basis, const void* melw,
           void* out, int batch, int row_len, int n_frames, int hop,
           int k_pad, int n_pass, int mel_bins, float amin, float ref_db,
           void* stream) {
  const int smem = smem_bytes(mel_bins);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (n_frames + TF - 1) / TF);
  logmel_kernel<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, idx, static_cast<const float*>(basis),
      static_cast<const float*>(melw), static_cast<float*>(out), row_len,
      n_frames, hop, k_pad, n_pass, mel_bins, amin, ref_db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The host plan (ops/logmel_cuda.py:plan) lays the basis out in these tiles.
int sedx_logmel_bins_per_pass() { return BN; }
int sedx_logmel_k_tile() { return KT; }

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int sedx_logmel_launch(const void* xpad, const void* basis, const void* melw,
                       void* out, int batch, int padded_len, int n_frames,
                       int hop, int k_pad, int n_pass, int mel_bins,
                       float amin, float ref_db, void* stream) {
  return launch(static_cast<const float*>(xpad), nullptr, basis, melw, out,
                batch, padded_len, n_frames, hop, k_pad, n_pass, mel_bins,
                amin, ref_db, stream);
}

// The bank entry: `bank` holds rows of row_len samples of sample_bytes each
// (4: float, 2: int16); clip b is row idx[b] (every row in order when idx is
// null). Returns cudaGetLastError(), or cudaErrorInvalidValue for another
// sample size.
int sedx_logmel_bank_launch(const void* bank, int sample_bytes,
                            const void* idx, const void* basis,
                            const void* melw, void* out, int batch,
                            int row_len, int n_frames, int hop, int k_pad,
                            int n_pass, int mel_bins, float amin,
                            float ref_db, void* stream) {
  const int* index = static_cast<const int*>(idx);
  if (sample_bytes == 4)
    return launch(static_cast<const float*>(bank), index, basis, melw, out,
                  batch, row_len, n_frames, hop, k_pad, n_pass, mel_bins,
                  amin, ref_db, stream);
  if (sample_bytes == 2)
    return launch(static_cast<const int16_t*>(bank), index, basis, melw, out,
                  batch, row_len, n_frames, hop, k_pad, n_pass, mel_bins,
                  amin, ref_db, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sedx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
