// sedx_native — host-side audio ingest in C++: the port's copy.
//
// The PyTorch port's copy of native/sedx_native.cc, identical to it apart
// from this header comment (tests/test_torch_isolation.py checks that with
// comments stripped). The port builds it at first use with g++ and the
// flags of native/Makefile into sound_event_detection_dcase2017_task4_torch/
// _build/ and binds it with ctypes (native.py); it never runs the Makefile,
// which writes into the JAX package.
//
// It decodes WAVs (PCM 8/16/24/32-bit, IEEE float, WAVE_FORMAT_EXTENSIBLE),
// resamples and pads them with a thread pool, for `features
// calculate_feature_for_all_audio_files`, whose log-mel then runs on the
// card.
//
// Exposed C ABI (ctypes):
//   sedx_load_wav(path, target_sr, out, max_samples)         -> n or -errno
//   sedx_load_wav_batch(paths, n, target_sr, out, max, nthr) -> 0 or -(i+1)
//   sedx_resample_poly(in, n_in, up, down, out, n_out_cap)   -> n_out
//
// The polyphase resampler replicates scipy.signal.resample_poly's design
// (firwin windowed-sinc, Kaiser beta 5.0, half_len = 10*max(up,down),
// unity-DC scaling, centered group delay), so its outputs match the Python
// loader (audio_io.resample) to float tolerance — tested in
// tests/test_torch_features.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>
#include <atomic>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- WAV ----
struct WavInfo {
  int sample_rate = 0;
  int channels = 0;
  int bits = 0;
  int format = 0;  // 1 = PCM, 3 = IEEE float
  const uint8_t* data = nullptr;
  size_t data_len = 0;
};

bool parse_wav(const uint8_t* buf, size_t len, WavInfo* info) {
  if (len < 44 || memcmp(buf, "RIFF", 4) || memcmp(buf + 8, "WAVE", 4))
    return false;
  size_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    const char* id = reinterpret_cast<const char*>(buf + pos);
    uint32_t sz;
    memcpy(&sz, buf + pos + 4, 4);
    if (!memcmp(id, "fmt ", 4) && pos + 8 + 16 <= len) {
      uint16_t fmt, ch, bits;
      uint32_t sr;
      memcpy(&fmt, buf + pos + 8, 2);
      memcpy(&ch, buf + pos + 10, 2);
      memcpy(&sr, buf + pos + 12, 4);
      memcpy(&bits, buf + pos + 22, 2);
      if (fmt == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: the real format code is the first two
        // bytes of the SubFormat GUID at offset 24 of the fmt chunk; a
        // truncated extensible header is rejected rather than mis-decoded
        // (a float32 extensible WAV read as int32 PCM yields garbage).
        if (sz >= 40 && pos + 8 + 26 <= len) {
          uint16_t sub;
          memcpy(&sub, buf + pos + 8 + 24, 2);
          fmt = sub;
        } else {
          return false;
        }
      }
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = static_cast<int>(sr);
      info->bits = bits;
      have_fmt = true;
    } else if (!memcmp(id, "data", 4)) {
      info->data = buf + pos + 8;
      info->data_len = std::min<size_t>(sz, len - pos - 8);
      if (have_fmt) return true;
    }
    pos += 8 + sz + (sz & 1);  // chunks are word-aligned
  }
  return have_fmt && info->data != nullptr;
}

// Decode to mono float32 in [-1, 1]. Returns frame count or -1.
int64_t decode_mono(const WavInfo& w, std::vector<float>* out) {
  if (w.channels <= 0) return -1;
  const int bytes = w.bits / 8;
  if (bytes <= 0) return -1;
  const int64_t frames =
      static_cast<int64_t>(w.data_len) / (bytes * w.channels);
  out->resize(frames);
  const uint8_t* p = w.data;
  const float inv_ch = 1.0f / w.channels;
  for (int64_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < w.channels; ++c) {
      const uint8_t* s = p + (i * w.channels + c) * bytes;
      float v = 0.0f;
      if (w.format == 3 && w.bits == 32) {  // IEEE float
        float f;
        memcpy(&f, s, 4);
        v = f;
      } else if (w.bits == 16) {
        int16_t x;
        memcpy(&x, s, 2);
        v = x / 32768.0f;
      } else if (w.bits == 8) {
        v = (static_cast<int>(s[0]) - 128) / 128.0f;
      } else if (w.bits == 24) {
        int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
        if (x & 0x800000) x -= 0x1000000;
        v = x / 8388608.0f;
      } else if (w.bits == 32) {
        int32_t x;
        memcpy(&x, s, 4);
        v = x / 2147483648.0f;
      } else {
        return -1;
      }
      acc += v;
    }
    (*out)[i] = acc * inv_ch;
  }
  return frames;
}

// ---------------------------------------------------------- resampling ----
double bessel_i0(double x) {
  // series expansion; converges fast for the beta range used here
  double sum = 1.0, term = 1.0;
  const double y = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= y / (k * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

// scipy resample_poly filter: firwin(2*half_len+1, 1/max(up,down),
// window=('kaiser', 5.0)), unity-DC scaling, then *= up.
std::vector<double> design_filter(int up, int down) {
  const int m = std::max(up, down);
  const int half_len = 10 * m;
  const int n_taps = 2 * half_len + 1;
  const double fc = 1.0 / m;          // cutoff in Nyquist units
  const double beta = 5.0;
  const double i0b = bessel_i0(beta);
  std::vector<double> h(n_taps);
  const double center = half_len;
  double dc = 0.0;
  for (int n = 0; n < n_taps; ++n) {
    const double t = n - center;
    // sinc lowpass at fc (normalized: sin(pi fc t)/(pi t))
    double s = (t == 0.0) ? fc : std::sin(M_PI * fc * t) / (M_PI * t);
    const double r = 2.0 * n / (n_taps - 1) - 1.0;
    const double win = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - r * r))) / i0b;
    h[n] = s * win;
    dc += h[n];
  }
  for (auto& v : h) v = v / dc * up;  // unity DC gain, then scale by up
  return h;
}

// Polyphase upfirdn with scipy resample_poly's centering/length semantics:
// n_out = ceil(n_in * up / down); output sample j is the filter centered at
// input position (j*down)/up.
int64_t resample_poly(const float* in, int64_t n_in, int up, int down,
                      float* out, int64_t n_out_cap) {
  if (up == down) {
    int64_t n = std::min<int64_t>(n_in, n_out_cap);
    memcpy(out, in, n * sizeof(float));
    return n;
  }
  const std::vector<double> h = design_filter(up, down);
  const int64_t half_len = (static_cast<int64_t>(h.size()) - 1) / 2;
  const int64_t n_out = (n_in * up + down - 1) / down;
  const int64_t n = std::min(n_out, n_out_cap);
  for (int64_t j = 0; j < n; ++j) {
    // position of output j in the upsampled stream, plus group delay
    const int64_t t = j * down + half_len;
    // x_up[k] = in[k/up] when k%up==0; y[j] = sum_k h[t-k]*x_up[k]
    // iterate over contributing input samples i = k/up
    const int64_t k_min = std::max<int64_t>(0, t - (int64_t)h.size() + 1);
    int64_t i0 = (k_min + up - 1) / up;              // first input index
    double acc = 0.0;
    for (int64_t i = i0; i <= t / up && i < n_in; ++i) {
      const int64_t tap = t - i * up;
      if (tap < static_cast<int64_t>(h.size())) acc += h[tap] * in[i];
    }
    out[j] = static_cast<float>(acc);
  }
  return n;
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

int64_t load_one(const char* path, int target_sr, float* out,
                 int64_t max_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  const long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    fclose(f);
    return -2;
  }
  fclose(f);

  WavInfo info;
  if (!parse_wav(buf.data(), buf.size(), &info)) return -3;
  std::vector<float> mono;
  if (decode_mono(info, &mono) < 0) return -4;

  memset(out, 0, max_samples * sizeof(float));   // zero pad-or-truncate
  if (target_sr <= 0 || target_sr == info.sample_rate) {
    const int64_t n =
        std::min<int64_t>(mono.size(), max_samples);
    memcpy(out, mono.data(), n * sizeof(float));
    return n;
  }
  const int g = gcd_int(target_sr, info.sample_rate);
  return resample_poly(mono.data(), mono.size(), target_sr / g,
                       info.sample_rate / g, out, max_samples);
}

}  // namespace

extern "C" {

int64_t sedx_load_wav(const char* path, int target_sr, float* out,
                      int64_t max_samples) {
  return load_one(path, target_sr, out, max_samples);
}

// Parallel batch load: paths is an array of C strings; out is a contiguous
// [n, max_samples] float32 buffer. Returns 0, or -(index+1) of the first
// file that failed.
int64_t sedx_load_wav_batch(const char** paths, int64_t n, int target_sr,
                            float* out, int64_t max_samples,
                            int num_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);
  if (num_threads <= 0)
    num_threads = std::max(1u, std::thread::hardware_concurrency());
  num_threads = std::min<int64_t>(num_threads, n);
  std::vector<std::thread> pool;
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        const int64_t i = next.fetch_add(1);
        if (i >= n || failed.load() != 0) return;
        if (load_one(paths[i], target_sr, out + i * max_samples,
                     max_samples) < 0) {
          int64_t expected = 0;
          failed.compare_exchange_strong(expected, -(i + 1));
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  return failed.load();
}

int64_t sedx_resample_poly(const float* in, int64_t n_in, int up, int down,
                           float* out, int64_t n_out_cap) {
  return resample_poly(in, n_in, up, down, out, n_out_cap);
}

}  // extern "C"
