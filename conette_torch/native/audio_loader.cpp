// conette_torch native audio loader.
//
// Native twin of the reference's torchaudio C++ path (WAV decode via sox +
// polyphase sinc resample, invoked from huggingface/preprocessor.py:79-141):
// RIFF/WAVE PCM decode (8/16/24/32-bit int, 32/64-bit float), channel mean,
// and Hann-windowed polyphase sinc resampling with EXACTLY the same filter
// math as ops/resample.py (lowpass_filter_width=6, rolloff=0.99). Each output
// sample runs only its phase's band of non-zero taps, from a bank built once
// for each pair of rates; the result is the dense sum's but for the order of
// summation (an f32 accumulator).
//
// Exposed as a C ABI for ctypes (no pybind11 in the image). All functions
// return 0 on success, negative error codes otherwise. The Python wrapper
// releases the GIL during calls, so a thread pool gives parallel decode.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <map>
#include <memory>
#include <mutex>
#include <utility>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrUnsupported = -3;
constexpr int kErrArg = -4;
constexpr int kErrInternal = -5;  // exception escaping across the C ABI
constexpr int64_t kChunkFrames = 16384;  // frames a file is read and decoded by

struct WavInfo {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;
  uint32_t data_size = 0;
};

int64_t file_size(FILE* f) {
  const long pos = ftell(f);
  if (fseek(f, 0, SEEK_END) != 0) return -1;
  const long end = ftell(f);
  fseek(f, pos, SEEK_SET);
  return end;
}

// All chunk sizes are validated against the real file size before any
// allocation: a crafted 4 GB chunk header is a format error, not bad_alloc.
int parse_header(FILE* f, WavInfo* info) {
  const int64_t fsize = file_size(f);
  if (fsize < 12) return kErrFormat;
  uint8_t riff[12];
  if (fread(riff, 1, 12, f) != 12) return kErrFormat;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0)
    return kErrFormat;
  bool have_fmt = false, have_data = false;
  while (!(have_fmt && have_data)) {
    uint8_t hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, hdr + 4, 4);
    const long chunk_start = ftell(f);
    if (chunk_start < 0 ||
        static_cast<int64_t>(size) > fsize - chunk_start)
      return kErrFormat;
    if (memcmp(hdr, "fmt ", 4) == 0) {
      if (size < 16) return kErrFormat;  // PCM fmt chunk is >= 16 bytes
      std::vector<uint8_t> fmt(size);
      if (fread(fmt.data(), 1, size, f) != size) return kErrFormat;
      memcpy(&info->format, fmt.data(), 2);
      memcpy(&info->channels, fmt.data() + 2, 2);
      memcpy(&info->sample_rate, fmt.data() + 4, 4);
      memcpy(&info->bits, fmt.data() + 14, 2);
      if (info->format == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE
        if (size < 26) return kErrFormat;
        memcpy(&info->format, fmt.data() + 24, 2);
      }
      have_fmt = true;
    } else if (memcmp(hdr, "data", 4) == 0) {
      info->data_offset = chunk_start;
      info->data_size = size;
      have_data = true;
      fseek(f, size + (size & 1), SEEK_CUR);
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  if (!(have_fmt && have_data)) return kErrFormat;
  if (info->bits == 0 || info->bits % 8 != 0 || info->channels == 0 ||
      info->sample_rate == 0)
    return kErrFormat;
  return 0;
}

// Decode interleaved samples to float32 in [-1, 1] (torchaudio scaling):
// nbytes / (bits / 8) of them, to dst.
int decode_samples(const uint8_t* raw, uint32_t nbytes, const WavInfo& info,
                   float* dst) {
  const uint32_t bytes_per = info.bits / 8;
  const uint32_t n = nbytes / bytes_per;
  if (info.format == 1) {  // PCM int
    switch (info.bits) {
      case 8:
        for (uint32_t i = 0; i < n; ++i)
          dst[i] = (static_cast<float>(raw[i]) - 128.0f) / 128.0f;
        break;
      case 16: {
        const int16_t* s = reinterpret_cast<const int16_t*>(raw);
        for (uint32_t i = 0; i < n; ++i) dst[i] = s[i] / 32768.0f;
        break;
      }
      case 24:
        for (uint32_t i = 0; i < n; ++i) {
          int32_t v = raw[3 * i] | (raw[3 * i + 1] << 8) | (raw[3 * i + 2] << 16);
          if (v & 0x800000) v -= 0x1000000;
          dst[i] = v / 8388608.0f;
        }
        break;
      case 32: {
        const int32_t* s = reinterpret_cast<const int32_t*>(raw);
        for (uint32_t i = 0; i < n; ++i) dst[i] = s[i] / 2147483648.0f;
        break;
      }
      default:
        return kErrUnsupported;
    }
  } else if (info.format == 3) {  // IEEE float
    if (info.bits == 32) {
      memcpy(dst, raw, n * 4);
    } else if (info.bits == 64) {
      const double* s = reinterpret_cast<const double*>(raw);
      for (uint32_t i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]);
    } else {
      return kErrUnsupported;
    }
  } else {
    return kErrUnsupported;
  }
  return 0;
}

int64_t gcd64(int64_t a, int64_t b) { return b == 0 ? a : gcd64(b, a % b); }

// Polyphase Hann-windowed sinc kernel — same math as ops/resample.py
// (torchaudio sinc_interp_hann semantics).
void build_kernel(int orig, int target, int lowpass_width, double rolloff,
                  std::vector<std::vector<float>>* kernels, int* width_out) {
  const double base_freq = std::min(orig, target) * rolloff;
  const int width = static_cast<int>(std::ceil(lowpass_width * orig / base_freq));
  *width_out = width;
  const int klen = 2 * width + orig;
  kernels->assign(target, std::vector<float>(klen));
  const double scale = base_freq / orig;
  for (int p = 0; p < target; ++p) {
    for (int k = 0; k < klen; ++k) {
      double idx = static_cast<double>(k - width) / orig;
      double t = -static_cast<double>(p) / target + idx;
      t *= base_freq;
      t = std::max(-(double)lowpass_width, std::min((double)lowpass_width, t));
      double window = std::cos(t * M_PI / lowpass_width / 2.0);
      window *= window;
      double tp = t * M_PI;
      double val = (tp == 0.0) ? 1.0 : std::sin(tp) / tp;
      (*kernels)[p][k] = static_cast<float>(val * window * scale);
    }
  }
}

// The bank of one (orig, target) pair as the resample runs it: only each
// phase's band of non-zero taps. Every tap outside [lo[p], lo[p] + taps) of
// the f32 bank is exactly 0.0 (the sinc is clipped at +-lowpass_width, where
// its Hann window is cos^2(pi/2)), so the band gives the dense sum but for
// the order of summation. taps is the widest band rounded up to kLanes, so
// that every phase runs the same vectorised loop; the band's taps past the
// bank's end are zero.
constexpr int kLanes = 8;

struct Bank {
  int orig = 0;    // the rates over their gcd
  int target = 0;
  int width = 0;   // build_kernel's width: the zeros padded before the signal
  int klen = 0;    // taps of each phase in the bank
  int taps = 0;    // taps of each phase's band
  int reach = 0;   // max(lo) + taps: the samples a frame's bands read
  std::vector<int32_t> lo;  // (target,) first tap of each band
  std::vector<float> band;  // (target, taps)
};

std::shared_ptr<const Bank> make_bank(int orig, int target) {
  auto bank = std::make_shared<Bank>();
  bank->orig = orig;
  bank->target = target;
  std::vector<std::vector<float>> kernels;
  build_kernel(orig, target, 6, 0.99, &kernels, &bank->width);
  bank->klen = 2 * bank->width + orig;
  const int klen = bank->klen;
  bank->lo.assign(target, 0);
  int widest = 1;
  for (int p = 0; p < target; ++p) {
    const std::vector<float>& k = kernels[p];
    int first = 0, last = klen - 1;
    while (first < klen && k[first] == 0.0f) ++first;
    while (last > first && k[last] == 0.0f) --last;
    if (first == klen) first = last = 0;  // an all-zero phase
    bank->lo[p] = first;
    widest = std::max(widest, last - first + 1);
  }
  bank->taps = (widest + kLanes - 1) / kLanes * kLanes;
  const int taps = bank->taps;
  bank->reach = *std::max_element(bank->lo.begin(), bank->lo.end()) + taps;
  bank->band.assign(static_cast<size_t>(target) * taps, 0.0f);
  for (int p = 0; p < target; ++p) {
    const int lo = bank->lo[p];
    const int n = std::min(taps, klen - lo);
    std::copy(kernels[p].begin() + lo, kernels[p].begin() + lo + n,
              bank->band.begin() + static_cast<size_t>(p) * taps);
  }
  return bank;
}

// The bank of a pair of rates, built on first use and shared by every thread.
std::shared_ptr<const Bank> bank_for(int orig_freq, int target_freq) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, std::shared_ptr<const Bank>> cache;
  const int64_t g = gcd64(orig_freq, target_freq);
  const std::pair<int, int> key(static_cast<int>(orig_freq / g),
                                static_cast<int>(target_freq / g));
  std::lock_guard<std::mutex> hold(mu);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  if (cache.size() >= 64) cache.clear();  // banks in use stay alive
  auto bank = make_bank(key.first, key.second);
  cache.emplace(key, bank);
  return bank;
}

// kLanes floats as one vector register (GCC's vector extension).
typedef float Lanes __attribute__((vector_size(kLanes * sizeof(float))));

inline Lanes load_lanes(const float* p) {
  Lanes v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

int64_t resampled_len(int64_t length, int orig_freq, int target_freq) {
  const int64_t g = gcd64(orig_freq, target_freq);
  const int64_t orig = orig_freq / g, target = target_freq / g;
  return (length * target + orig - 1) / orig;  // ceil(target * len / orig)
}

// The zeros the resample reads after a signal: width + orig, and the
// widest band's reach past klen in the last frame.
int64_t pad_after(const Bank& bank) {
  return bank.width + bank.orig + std::max(0, bank.reach - bank.klen);
}

// Resample the length samples at xp + bank.width, with bank.width zeros
// before them and pad_after(bank) after, into the resampled_len(length, ...)
// floats at dst: out[f * target + p] = sum_j xp[f * orig + lo[p] + j] *
// band[p][j], taps / kLanes vector multiply-adds each.
void resample_padded(const float* xp, int64_t length, const Bank& bank, float* dst) {
  const int orig = bank.orig, target = bank.target, taps = bank.taps;
  const int64_t target_len = (length * target + orig - 1) / orig;
  const int64_t n_frames = (length + 2 * bank.width + orig - bank.klen) / orig + 1;
  const int32_t* lo = bank.lo.data();
  const float* band = bank.band.data();
  for (int64_t frame = 0; frame < n_frames; ++frame) {
    const float* seg = xp + frame * orig;
    const int64_t first = frame * target;
    const int phases = static_cast<int>(std::min<int64_t>(target, target_len - first));
    for (int p = 0; p < phases; ++p) {
      const float* s = seg + lo[p];
      const float* b = band + static_cast<size_t>(p) * taps;
      Lanes acc = load_lanes(s) * load_lanes(b);
      for (int c = kLanes; c < taps; c += kLanes) acc += load_lanes(s + c) * load_lanes(b + c);
      float sum = 0.0f;
      for (int k = 0; k < kLanes; ++k) sum += acc[k];
      dst[first + p] = sum;
    }
  }
}

int wav_info_impl(const char* path, int32_t* sample_rate, int32_t* channels,
                  int64_t* num_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  WavInfo info;
  int rc = parse_header(f, &info);
  fclose(f);
  if (rc != 0) return rc;
  *sample_rate = static_cast<int32_t>(info.sample_rate);
  *channels = static_cast<int32_t>(info.channels);
  *num_frames = static_cast<int64_t>(info.data_size) / (info.bits / 8) / info.channels;
  return 0;
}

int load_resample_mono_impl(const char* path, int32_t target_sr, float* out,
                            int64_t out_capacity, int64_t* out_len) {
  if (!out || !out_len) return kErrArg;
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  WavInfo info;
  int rc = parse_header(f, &info);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  // read and decode kChunkFrames frames at a time, straight into the mono
  // signal where the file has one channel; the signal lies between the zeros
  // that the resample reads around it
  const int sr = static_cast<int>(info.sample_rate);
  const bool resample = target_sr > 0 && target_sr != sr;
  const std::shared_ptr<const Bank> bank = resample ? bank_for(sr, target_sr) : nullptr;
  const int64_t before = resample ? bank->width : 0;
  const int ch = info.channels;
  const int64_t frame_bytes = static_cast<int64_t>(info.bits / 8) * ch;
  const int64_t max_frames = info.data_size / frame_bytes;
  std::vector<float> padded(before + max_frames + (resample ? pad_after(*bank) : 0));
  float* mono = padded.data() + before;
  std::vector<uint8_t> raw(kChunkFrames * frame_bytes);
  std::vector<float> chunk(ch == 1 ? 0 : kChunkFrames * ch);
  fseek(f, info.data_offset, SEEK_SET);
  int64_t frames = 0;
  while (rc == 0) {
    const int64_t want = std::min<int64_t>(kChunkFrames, max_frames - frames) * frame_bytes;
    const int64_t got = static_cast<int64_t>(fread(raw.data(), 1, want, f));
    const int64_t nf = got / frame_bytes;
    float* dst = ch == 1 ? mono + frames : chunk.data();
    rc = decode_samples(raw.data(), static_cast<uint32_t>(nf * frame_bytes), info, dst);
    if (rc == 0 && ch > 1) {
      for (int64_t i = 0; i < nf; ++i) {
        double acc = 0.0;
        for (int c = 0; c < ch; ++c) acc += chunk[i * ch + c];
        mono[frames + i] = static_cast<float>(acc / ch);
      }
    }
    frames += nf;
    if (got < want || want == 0) break;
  }
  fclose(f);
  if (rc != 0) return rc;

  const int64_t n = resample ? resampled_len(frames, sr, target_sr) : frames;
  if (n > out_capacity) return kErrArg;
  if (resample) {
    resample_padded(padded.data(), frames, *bank, out);
  } else {
    memcpy(out, mono, n * sizeof(float));
  }
  *out_len = n;
  return 0;
}

int resample_impl(const float* x, int64_t n, int32_t orig_sr,
                  int32_t target_sr, float* out, int64_t out_capacity,
                  int64_t* out_len) {
  if (!x || !out || !out_len) return kErrArg;
  if (orig_sr <= 0 || target_sr <= 0) return kErrArg;
  const int64_t m = orig_sr == target_sr ? n : resampled_len(n, orig_sr, target_sr);
  if (m > out_capacity) return kErrArg;
  if (orig_sr == target_sr) {
    memcpy(out, x, m * sizeof(float));
  } else {
    const std::shared_ptr<const Bank> bank = bank_for(orig_sr, target_sr);
    std::vector<float> padded(bank->width + n + pad_after(*bank));
    std::copy(x, x + n, padded.begin() + bank->width);
    resample_padded(padded.data(), n, *bank, out);
  }
  *out_len = m;
  return 0;
}

int resample_taps_impl(int32_t orig_sr, int32_t target_sr, int32_t* band_taps,
                       int32_t* bank_taps) {
  if (!band_taps || !bank_taps) return kErrArg;
  if (orig_sr <= 0 || target_sr <= 0) return kErrArg;
  if (orig_sr == target_sr) {
    *band_taps = *bank_taps = 0;
    return 0;
  }
  const std::shared_ptr<const Bank> bank = bank_for(orig_sr, target_sr);
  *band_taps = bank->taps;
  *bank_taps = bank->klen;
  return 0;
}

}  // namespace

extern "C" {

// Query: returns 0 and fills (sample_rate, channels, num_frames).
int conette_wav_info(const char* path, int32_t* sample_rate, int32_t* channels,
                     int64_t* num_frames) {
  try {
    return wav_info_impl(path, sample_rate, channels, num_frames);
  } catch (...) {
    return kErrInternal;
  }
}

// Decode + channel-mean + optional resample to target_sr (0 = native rate).
// Writes at most out_capacity floats to out; returns actual length via
// out_len. Call conette_wav_info first to size the buffer:
// capacity >= ceil(num_frames * target_sr / sample_rate) + 16.
int conette_load_resample_mono(const char* path, int32_t target_sr, float* out,
                               int64_t out_capacity, int64_t* out_len) {
  try {
    return load_resample_mono_impl(path, target_sr, out, out_capacity, out_len);
  } catch (...) {
    return kErrInternal;
  }
}

// Standalone resample of a float32 mono buffer (the preprocessor's arrays).
int conette_resample(const float* x, int64_t n, int32_t orig_sr,
                     int32_t target_sr, float* out, int64_t out_capacity,
                     int64_t* out_len) {
  try {
    return resample_impl(x, n, orig_sr, target_sr, out, out_capacity, out_len);
  } catch (...) {
    return kErrInternal;
  }
}

// The taps each output sample runs (band_taps) and the taps of each phase of
// the dense bank (bank_taps) to resample orig_sr -> target_sr; both 0 where
// the rates are equal.
int conette_resample_taps(int32_t orig_sr, int32_t target_sr, int32_t* band_taps,
                          int32_t* bank_taps) {
  try {
    return resample_taps_impl(orig_sr, target_sr, band_taps, bank_taps);
  } catch (...) {
    return kErrInternal;
  }
}

}  // extern "C"
