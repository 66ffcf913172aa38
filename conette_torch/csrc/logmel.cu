// The log-mel frontend in one pass, f32 waveform in, f32 log-mel out:
//
//   spec  = frames · basis          (frames and basis rounded to the compute
//                                     type, f32 accumulation)
//   power = re² + im²               (rounded to the compute type)
//   mel   = power · melfb           (melfb rounded, f32 accumulation)
//   out   = (10·ln(max(amin, mel)) / ln 10 − log_ref) · scale + shift
//
// Replaces the TPU kernel conette_tpu/ops/pallas/logmel.py:
// fused_logmel_frames (body _logmel_kernel), reached through fused_logmel,
// with the inference bn0 folded into (scale, shift). It ports the math, not
// the Mosaic layout: no lane padding of the output (513 -> 640, 224 -> 256),
// no 128-frame tile, and no (B, T, 1024) frames tensor in device memory.
//
// What bounds it on the H100: at batch 8 x 10 s the least work is one
// multiply-add a frame for each nonzero entry of the windowed DFT basis
// (1024 x 1026 less a zero row and two zero columns) and of the mel
// filterbank (884 of its 513 x 224 entries): 16.8 GFLOP against about
// 20 MB of waveform, basis and output, so the bf16 variant is bound by the
// tensor cores (0.017 ms at 989 TFLOP/s) and the f32 variant by the f32 FMA
// pipes (0.25 ms at 67 TFLOP/s); the bytes need 0.006 ms. This kernel does
// the filterbank product densely (1.8 GFLOP more, nearly all on zeros).
//
// What the design does about it: the (T, 1026) spectrum and the power stay
// on the SM, and the frames are never materialised. A thread block owns
// kTM = 64 frames of one clip. It loads the span of the reflect-padded
// waveform those frames cover ((kTM - 1)·hop + 1024 samples) into shared
// memory once, rounded to the compute type; frame r is the row that starts
// at sample r·hop, so the frames matrix is the shared waveform read with a
// row stride of hop. It walks the 513 frequencies in 17 chunks of kNC = 32
// (the basis holds each chunk's 32 real columns next to its 32 imaginary
// ones; frequencies 513..543 are zero columns): per chunk it accumulates re
// and im over K = 1024, forms the power, rounds it into shared memory and
// adds power · melfb[chunk] into the (64, 224) mel accumulators, which stay
// in registers for the whole block. The epilogue clamps, takes the log,
// applies the affine and writes only the 224 real columns of the real rows.
//   bf16: WMMA 16x16x16 bf16 on the tensor cores, f32 accumulation; each
//         chunk's (1024, 64) basis columns are staged in shared memory once
//         for the block's 8 warps; each warp owns the matching re and im
//         tiles, so the power is formed in its accumulator fragments.
//   f32:  exact f32 FMA on the CUDA cores (no TF32): each thread owns 8
//         frames x 1 frequency in the DFT and 8 frames x 7 mel bins after.
// The rounding points are those of the plain PyTorch version
// (conette_torch/kernels/logmel.py::logmel_reference), so the two differ
// only by f32 summation order. The filterbank's zero tiles are not skipped;
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

using namespace nvcuda;

namespace {

constexpr int kNfft = 1024;
constexpr int kMels = 224;
constexpr int kTM = 64;                      // frames per thread block
constexpr int kNC = 32;                      // frequencies per chunk
constexpr int kChunks = 17;                  // ceil(513 / kNC)
constexpr int kBasisLd = 2 * kNC * kChunks;  // 1088 basis columns
constexpr int kThreads = 256;                // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLDS = kNC + 4;                // f32 power staging row stride
constexpr int kLDP = kNC + 8;                // bf16 power row stride (32-byte rows)
constexpr int kLDB = 2 * kNC + 8;            // bf16 basis-chunk row stride in shared memory
constexpr int kSkew = 16;                    // bf16 gap after every hop samples (bf16 kernel)
constexpr int kMelTiles = (kTM / 16) * (kMels / 16) / kWarps;  // 7 a warp
constexpr float kLn10 = 2.302585092994046f;

__host__ __device__ constexpr size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

__host__ __device__ inline int span_of(int hop) { return (kTM - 1) * hop + kNfft; }

// The bf16 kernel stores sample i of the span at i + kSkew·(i / hop): frame
// rows then start 8 banks apart instead of on one bank (hop = 320 is a
// multiple of 32 words), and a 16-wide k-tile never crosses a gap because
// hop is a multiple of 16.
__host__ __device__ inline int skewed_span(int hop) {
  return span_of(hop) + kSkew * (span_of(hop) / hop + 1);
}

__device__ __forceinline__ float to_db(float mel, int m, const float* scale, const float* shift,
                                       float amin, float log_ref) {
  const float db = 10.0f * logf(fmaxf(amin, mel)) / kLn10 - log_ref;
  return db * __ldg(scale + m) + __ldg(shift + m);
}

size_t smem_bf16(int hop) {
  return round_up(sizeof(__nv_bfloat16) * skewed_span(hop), 128) +
         sizeof(__nv_bfloat16) * kNfft * kLDB + sizeof(float) * kTM * kLDS +
         sizeof(__nv_bfloat16) * kTM * kLDP;
}

size_t smem_f32(int hop) {
  return round_up(sizeof(float) * span_of(hop), 128) + sizeof(float) * kTM * kNC;
}

__global__ void __launch_bounds__(kThreads)
logmel_bf16_kernel(const float* __restrict__ xp,              // (B, S_pad)
                   const __nv_bfloat16* __restrict__ basis,   // (1024, kBasisLd)
                   const __nv_bfloat16* __restrict__ melfb,   // (kNC·kChunks, 224)
                   const float* __restrict__ scale,           // (224)
                   const float* __restrict__ shift,           // (224)
                   float* __restrict__ out,                   // (B, T, 224)
                   int S_pad, int T, int hop, float amin, float log_ref) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int span = span_of(hop);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  const size_t ws_bytes = round_up(sizeof(__nv_bfloat16) * skewed_span(hop), 128);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + ws_bytes);
  float* stage = reinterpret_cast<float*>(bs + kNfft * kLDB);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(stage + kTM * kLDS);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTM;

  // ---- the tile's waveform span, rounded to bf16 (zeros past the end)
  {
    const float* src = xp + static_cast<size_t>(b) * S_pad + static_cast<size_t>(t0) * hop;
    const int avail = S_pad - t0 * hop;
    for (int i = threadIdx.x; i < span; i += kThreads) {
      ws[i + kSkew * (i / hop)] = __float2bfloat16(i < avail ? __ldg(src + i) : 0.0f);
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> macc[kMelTiles];
#pragma unroll
  for (int i = 0; i < kMelTiles; ++i) wmma::fill_fragment(macc[i], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> br, bi;

  const int rt = warp % (kTM / 16);  // this warp's 16 frames in the DFT
  const int ct = warp / (kTM / 16);  // and its 16 frequencies of the chunk
  for (int j = 0; j < kChunks; ++j) {
    // ---- the chunk's (1024, 2·kNC) basis columns into shared memory, once
    // for all 8 warps (16-byte loads; rows stay 16-byte aligned)
    {
      constexpr int kVecs = 2 * kNC / 8;  // uint4 a row
      const __nv_bfloat16* src = basis + j * 2 * kNC;
#pragma unroll 8
      for (int i = threadIdx.x; i < kNfft * kVecs; i += kThreads) {
        const int r = i / kVecs;
        const int c = i % kVecs;
        *reinterpret_cast<uint4*>(bs + r * kLDB + c * 8) =
            __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * kBasisLd + c * 8));
      }
    }
    __syncthreads();

    // ---- re and im of (16 frames, 16 frequencies) over K = 1024
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> re, im;
    wmma::fill_fragment(re, 0.0f);
    wmma::fill_fragment(im, 0.0f);
    const __nv_bfloat16* bre = bs + ct * 16;
    const __nv_bfloat16* bim = bre + kNC;
    const __nv_bfloat16* frames = ws + rt * 16 * (hop + kSkew);
    for (int k0 = 0; k0 < kNfft; k0 += 16) {
      wmma::load_matrix_sync(a, frames + k0 + kSkew * (k0 / hop), hop + kSkew);
      wmma::load_matrix_sync(br, bre + k0 * kLDB, kLDB);
      wmma::load_matrix_sync(bi, bim + k0 * kLDB, kLDB);
      wmma::mma_sync(re, a, br, re);
      wmma::mma_sync(im, a, bi, im);
    }
    // the two fragments share one element layout: power in place
#pragma unroll
    for (int e = 0; e < re.num_elements; ++e) re.x[e] = re.x[e] * re.x[e] + im.x[e] * im.x[e];
    float* st = stage + rt * 16 * kLDS + ct * 16;
    wmma::store_matrix_sync(st, re, kLDS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16;
      const int c = e % 16;
      ps[(rt * 16 + r) * kLDP + ct * 16 + c] = __float2bfloat16(st[r * kLDS + c]);
    }
    __syncthreads();

    // ---- mel += power (64 x kNC) · melfb[chunk] (kNC x 224)
#pragma unroll
    for (int i = 0; i < kMelTiles; ++i) {
      const int tile = warp + i * kWarps;
      const int mrt = tile % (kTM / 16);
      const int mct = tile / (kTM / 16);
#pragma unroll
      for (int kk = 0; kk < kNC; kk += 16) {
        wmma::load_matrix_sync(a, ps + mrt * 16 * kLDP + kk, kLDP);
        wmma::load_matrix_sync(
            br, melfb + static_cast<size_t>(j * kNC + kk) * kMels + mct * 16, kMels);
        wmma::mma_sync(macc[i], a, br, macc[i]);
      }
    }
    __syncthreads();  // bs, stage and ps are rewritten by the next chunk
  }

  // ---- epilogue: dB, affine, the real rows and columns only
  float* scratch = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < kMelTiles; ++i) {
    const int tile = warp + i * kWarps;
    const int mrt = tile % (kTM / 16);
    const int mct = tile / (kTM / 16);
    wmma::store_matrix_sync(scratch, macc[i], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int t = t0 + mrt * 16 + e / 16;
      const int m = mct * 16 + e % 16;
      if (t < T) {
        out[(static_cast<size_t>(b) * T + t) * kMels + m] =
            to_db(scratch[e], m, scale, shift, amin, log_ref);
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
logmel_f32_kernel(const float* __restrict__ xp,      // (B, S_pad)
                  const float* __restrict__ basis,   // (1024, kBasisLd)
                  const float* __restrict__ melfb,   // (kNC·kChunks, 224)
                  const float* __restrict__ scale,   // (224)
                  const float* __restrict__ shift,   // (224)
                  float* __restrict__ out,           // (B, T, 224)
                  int S_pad, int T, int hop, float amin, float log_ref) {
  constexpr int kRows = kTM / kWarps;    // 8 frames a thread
  constexpr int kCols = kMels / 32;      // 7 mel bins a thread
  extern __shared__ __align__(128) unsigned char smem[];
  const int span = span_of(hop);
  float* ws = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + round_up(sizeof(float) * span, 128));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTM;

  {
    const float* src = xp + static_cast<size_t>(b) * S_pad + static_cast<size_t>(t0) * hop;
    const int avail = S_pad - t0 * hop;
    for (int i = threadIdx.x; i < span; i += kThreads) ws[i] = i < avail ? __ldg(src + i) : 0.0f;
  }
  __syncthreads();

  float macc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) macc[r][c] = 0.0f;

  const float* rows = ws + warp * kRows * hop;
  for (int j = 0; j < kChunks; ++j) {
    // ---- re and im of frames warp·8 .. +7 at frequency j·kNC + lane
    float re[kRows], im[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) re[r] = im[r] = 0.0f;
    const float* bre = basis + j * 2 * kNC + lane;
    const float* bim = bre + kNC;
    for (int k = 0; k < kNfft; k += 4) {
      float cr[4], ci[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cr[u] = __ldg(bre + static_cast<size_t>(k + u) * kBasisLd);
        ci[u] = __ldg(bim + static_cast<size_t>(k + u) * kBasisLd);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 f = *reinterpret_cast<const float4*>(rows + r * hop + k);
        re[r] = fmaf(f.x, cr[0], re[r]);
        im[r] = fmaf(f.x, ci[0], im[r]);
        re[r] = fmaf(f.y, cr[1], re[r]);
        im[r] = fmaf(f.y, ci[1], im[r]);
        re[r] = fmaf(f.z, cr[2], re[r]);
        im[r] = fmaf(f.z, ci[2], im[r]);
        re[r] = fmaf(f.w, cr[3], re[r]);
        im[r] = fmaf(f.w, ci[3], im[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ps[(warp * kRows + r) * kNC + lane] = re[r] * re[r] + im[r] * im[r];
    }
    __syncthreads();

    // ---- mel += power (64 x kNC) · melfb[chunk] (kNC x 224)
    const float* fb = melfb + static_cast<size_t>(j) * kNC * kMels + lane;
#pragma unroll 4
    for (int kk = 0; kk < kNC; ++kk) {
      float w[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) w[c] = __ldg(fb + kk * kMels + 32 * c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = ps[(warp * kRows + r) * kNC + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) macc[r][c] = fmaf(p, w[c], macc[r][c]);
      }
    }
    __syncthreads();  // ps is rewritten by the next chunk
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + warp * kRows + r;
    if (t < T) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int m = lane + 32 * c;
        out[(static_cast<size_t>(b) * T + t) * kMels + m] =
            to_db(macc[r][c], m, scale, shift, amin, log_ref);
      }
    }
  }
}

}  // namespace

// C entry point: returns the cudaError_t of the launch (0 on success).
// xp is the reflect-padded waveform (B, S_pad) f32; basis and melfb are in
// the compute type (bf16 when use_bf16, else f32); out is (B, T, 224) f32.
extern "C" int conette_logmel(const void* xp, const void* basis, const void* melfb,
                              const void* scale, const void* shift, void* out, int B, int S_pad,
                              int T, int hop, int use_bf16, float amin, float log_ref,
                              void* stream) {
  if (B < 1 || T < 1 || hop % 16 || (T - 1) * hop + kNfft > S_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTM - 1) / kTM, B);
  cudaError_t err;
  if (use_bf16) {
    const size_t smem = smem_bf16(hop);
    err = cudaFuncSetAttribute(logmel_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    logmel_bf16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(xp), static_cast<const __nv_bfloat16*>(basis),
        static_cast<const __nv_bfloat16*>(melfb), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<float*>(out), S_pad, T, hop, amin, log_ref);
  } else {
    const size_t smem = smem_f32(hop);
    err = cudaFuncSetAttribute(logmel_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    logmel_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(basis),
        static_cast<const float*>(melfb), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<float*>(out), S_pad, T, hop, amin, log_ref);
  }
  return cudaGetLastError();
}
