// conette_tpu native audio loader.
//
// Native twin of the reference's torchaudio C++ path (WAV decode via sox +
// polyphase sinc resample, invoked from huggingface/preprocessor.py:79-141):
// RIFF/WAVE PCM decode (8/16/24/32-bit int, 32/64-bit float), channel mean,
// and Hann-windowed polyphase sinc resampling with EXACTLY the same filter
// math as ops/resample.py (lowpass_filter_width=6, rolloff=0.99) so the
// native and JAX paths are bit-comparable.
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

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrUnsupported = -3;
constexpr int kErrArg = -4;
constexpr int kErrInternal = -5;  // exception escaping across the C ABI

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

// Decode interleaved samples to float32 in [-1, 1] (torchaudio scaling).
int decode_samples(const uint8_t* raw, uint32_t nbytes, const WavInfo& info,
                   std::vector<float>* out) {
  const uint32_t bytes_per = info.bits / 8;
  const uint32_t n = nbytes / bytes_per;
  out->resize(n);
  float* dst = out->data();
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

void resample_mono(const std::vector<float>& x, int orig_freq, int target_freq,
                   std::vector<float>* out) {
  if (orig_freq == target_freq) {
    *out = x;
    return;
  }
  const int64_t g = gcd64(orig_freq, target_freq);
  const int orig = static_cast<int>(orig_freq / g);
  const int target = static_cast<int>(target_freq / g);
  std::vector<std::vector<float>> kernels;
  int width = 0;
  build_kernel(orig, target, 6, 0.99, &kernels, &width);
  const int klen = 2 * width + orig;

  const int64_t length = static_cast<int64_t>(x.size());
  const int64_t target_len =
      (length * target + orig - 1) / orig;  // ceil(target * len / orig)
  out->assign(target_len, 0.0f);

  // padded signal: width zeros front, width + orig back
  std::vector<float> xp(length + 2 * width + orig, 0.0f);
  std::copy(x.begin(), x.end(), xp.begin() + width);

  const int64_t n_frames = (static_cast<int64_t>(xp.size()) - klen) / orig + 1;
  for (int64_t frame = 0; frame < n_frames; ++frame) {
    const float* seg = xp.data() + frame * orig;
    for (int p = 0; p < target; ++p) {
      const int64_t out_idx = frame * target + p;
      if (out_idx >= target_len) break;
      const float* kern = kernels[p].data();
      double acc = 0.0;
      for (int k = 0; k < klen; ++k) acc += seg[k] * kern[k];
      (*out)[out_idx] = static_cast<float>(acc);
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
  std::vector<uint8_t> raw(info.data_size);
  fseek(f, info.data_offset, SEEK_SET);
  size_t got = fread(raw.data(), 1, info.data_size, f);
  fclose(f);
  raw.resize(got);

  std::vector<float> interleaved;
  rc = decode_samples(raw.data(), static_cast<uint32_t>(raw.size()), info,
                      &interleaved);
  if (rc != 0) return rc;

  const int ch = info.channels;
  const int64_t frames = static_cast<int64_t>(interleaved.size()) / ch;
  std::vector<float> mono(frames);
  if (ch == 1) {
    mono.assign(interleaved.begin(), interleaved.begin() + frames);
  } else {
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (int c = 0; c < ch; ++c) acc += interleaved[i * ch + c];
      mono[i] = static_cast<float>(acc / ch);
    }
  }

  std::vector<float> result;
  if (target_sr > 0 && target_sr != static_cast<int32_t>(info.sample_rate)) {
    resample_mono(mono, static_cast<int>(info.sample_rate), target_sr, &result);
  } else {
    result = std::move(mono);
  }
  const int64_t n = static_cast<int64_t>(result.size());
  if (n > out_capacity) return kErrArg;
  memcpy(out, result.data(), n * sizeof(float));
  *out_len = n;
  return 0;
}

int resample_impl(const float* x, int64_t n, int32_t orig_sr,
                  int32_t target_sr, float* out, int64_t out_capacity,
                  int64_t* out_len) {
  if (!x || !out || !out_len) return kErrArg;
  if (orig_sr <= 0 || target_sr <= 0) return kErrArg;
  std::vector<float> xin(x, x + n);
  std::vector<float> result;
  resample_mono(xin, orig_sr, target_sr, &result);
  const int64_t m = static_cast<int64_t>(result.size());
  if (m > out_capacity) return kErrArg;
  memcpy(out, result.data(), m * sizeof(float));
  *out_len = m;
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

// Standalone resample of a float32 mono buffer (for parity tests).
int conette_resample(const float* x, int64_t n, int32_t orig_sr,
                     int32_t target_sr, float* out, int64_t out_capacity,
                     int64_t* out_len) {
  try {
    return resample_impl(x, n, orig_sr, target_sr, out, out_capacity, out_len);
  } catch (...) {
    return kErrInternal;
  }
}

}  // extern "C"
