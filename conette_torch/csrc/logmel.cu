// The log-mel frontend in one pass, f32 waveform in, f32 log-mel out:
//
//   frames = reflect-padded x, n_fft samples every hop
//   spec   = frames · basis          (frames and basis rounded to the compute
//                                      type, f32 accumulation)
//   power  = re² + im²               (rounded to the compute type)
//   mel    = power · melfb           (melfb rounded, f32 accumulation)
//   out    = (10·ln(max(amin, mel)) / ln 10 − log_ref) · scale + shift
//
// Replaces the TPU kernel conette_tpu/ops/pallas/logmel.py:
// fused_logmel_frames (body _logmel_kernel), reached through fused_logmel,
// with the inference bn0 folded into (scale, shift). It ports the math, not
// the Mosaic layout: no lane padding of the output (513 -> 640, 224 -> 256),
// no 128-frame tile, no frames tensor and no padded waveform in device
// memory: the reflect pad is an index map of the kernel's own loads.
//
// What bounds it on the H100: at batch 8 x 10 s (8008 frames) the least
// work is one multiply-add a frame for each nonzero basis entry of the
// frequencies that the filterbank reads (rows 2..447 of its 513 are live at
// fmax 14 kHz: 446 x 2 x 1023 entries) and for each nonzero filterbank
// entry (884): 14.6 GFLOP, 0.0148 ms on the bf16 tensor cores at 989
// TFLOP/s, against 0.0057 ms for the bytes of waveform, basis and output.
// So the bf16 kernel is bound by operations. What it meets first is the
// basis: every 64-frame tile needs all of its live columns (1.84 MB as
// bf16), 235 MB from L2 a request, which the ring streams in about half of
// the kernel's time (so a cluster multicast of the stages bought nothing on
// the H100 and is not built); and with one consumer warpgroup a CTA, the
// time its products leave to the span load, the band products and the
// epilogue (scripts/_logmel_kernel_phases.py times each part).
//
// The bf16 kernel (logmel_bf16_kernel): a CTA owns kTM = 64 frames of
// one clip, 160 threads in two roles.
//   - It loads the span of the clip those frames cover ((kTM − 1)·hop +
//     n_fft samples) into shared memory once, rounded to bf16, reflecting
//     the index at both ends of the clip. Frame r is the row that starts at
//     sample r·hop, so the frames matrix is the span read with a row
//     stride of hop. A wgmma descriptor cannot express that stride, so A
//     comes from registers: ldmatrix.x4 from per-lane row pointers into the
//     span gives the m16n8k16 fragment that wgmma's register-A form takes.
//     A gap of kSpanSkew = 8 samples after every hop puts the 8 rows of an
//     8x8 matrix 16 bytes apart modulo 128 (hop·2 bytes is a multiple of
//     32), so no ldmatrix meets a bank twice.
//   - The live frequencies run in chunks of 64 (7 at the default cfg).
//     The wrapper packs the basis once per cfg, in wgmma's K-major
//     core-matrix order, with each frequency's re and im columns side by
//     side, so that the two columns an accumulator thread holds
//     (2·(lane % 4) and + 1) are re and im of one frequency. A producer
//     warp streams it through a ring of 16 KB stages (64 samples x 128
//     columns) by cp.async.bulk copies on mbarriers; a stage is refilled
//     once each consumer warp has released it.
//   - One consumer warpgroup runs wgmma m64n128k16, A from registers, B
//     from the ring, f32 accumulation in registers: two stages' products in
//     flight, A triple-buffered so that each stage's ldmatrix runs while
//     the two before it multiply, ring slots and parities counted without
//     a division. At the end of a chunk the power re² + im² forms in the
//     accumulator registers and is rounded to bf16 straight into register
//     A fragments for the mel product. Their k order differs from the
//     frequency order, so the filterbank rows are packed in the same
//     permuted order (k is only a summation index). Each chunk meets only a
//     band of mels (104, 44, 26, 19, 15, 13 and 10 at the default cfg): the
//     band product is one wgmma m64nNk16 pass (N in 16, 32, 64, 128) on that
//     chunk's banded filterbank, which stays in shared memory for the whole
//     CTA, and its sum is added at the band's offset into a (64, 224) f32
//     mel sum in shared memory that each warp owns for its own 16 rows, in
//     chunk order, so two launches give the same bits.
//   - The epilogue clamps, takes the log, applies the affine and writes
//     each warp's real rows as 16-byte stores from the mel sum, seven of a
//     lane's float4 at a time (four warps need that much independent work).
// The f32 kernel (logmel_f32_kernel) is on no route: exact f32 FMA on the
// CUDA cores (no TF32), 17 chunks of 32 frequencies of a dense layout, each
// thread 8 frames x 1 frequency in the DFT and 8 frames x 7 mel bins after.
// The rounding points are those of the plain PyTorch version
// (conette_torch/kernels/logmel.py::logmel_reference), so the two differ
// only by f32 summation order; skipping frequencies whose filterbank rows
// are zero leaves out products by exact zeros.
//
// C entry point: conette_logmel(x, basis, fb, bands, scale, shift, out, B,
// S, T, hop, n_chunks, fb_elems, use_bf16, amin, log_ref, stream),
// 7 pointers, 7 ints, 2 floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kNfft = 1024;
constexpr int kPad = kNfft / 2;  // the reflect pad at each end
constexpr int kMels = 224;
constexpr int kTM = kTileRows;   // frames per thread block
constexpr float kLn10 = 2.302585092994046f;
// 1 / ln 10 rounded to f32, as ATen divides a CUDA tensor by a host scalar:
// no division, so no slow-path branch, in the epilogue
constexpr float kInvLn10 = 1.0f / kLn10;
constexpr int kSmemMax = 232448;

// ---- the bf16 kernel
constexpr int kChunkFreqs = 64;                        // frequencies a chunk
constexpr int kStageK = 64;                            // samples a ring stage
constexpr int kStageSteps = kStageK / 16;              // k16 steps a stage
constexpr int kChunkStages = kNfft / kStageK;          // ring stages a chunk
constexpr int kStageBytes = kStageK * 2 * kChunkFreqs * 2;  // 16 KB
constexpr int kStepBytes = kStageBytes / kStageSteps;       // a k16 step of 128 columns
constexpr int kConsumers = 128;                        // one warpgroup
constexpr int kThreadsBf16 = kConsumers + 32;          // and a producer warp
constexpr int kSpanSkew = 8;                           // bf16 gap after every hop samples
constexpr int kMelLd = kMels + 8;                      // f32 mel-sum row stride
constexpr size_t kMelBytes = sizeof(float) * kTM * kMelLd;
constexpr int kSteps = kNfft / 16;                     // k16 steps over n_fft
constexpr int kMaxRing = 8;
constexpr int kMaxChunks = 9;                          // 576 frequencies >= 513

// ---- the f32 kernel
constexpr int kNC = 32;                      // frequencies per chunk
constexpr int kChunks = 17;                  // ceil(513 / kNC)
constexpr int kBasisLd = 2 * kNC * kChunks;  // 1088 basis columns
constexpr int kThreads = 256;                // 8 warps
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

__host__ __device__ inline int span_of(int hop) { return (kTM - 1) * hop + kNfft; }

// the bf16 span: sample i at i + kSpanSkew·(i / hop)
__host__ __device__ inline int skewed_span(int hop) {
  return span_of(hop) + kSpanSkew * (span_of(hop) / hop + 1);
}

// Sample p of the reflect-padded clip (p = x index + kPad): x reflected at
// both ends, zero past the padded end (only frames past the last one read
// there). S > kPad, so one reflection lands inside the clip. Branch-free:
// the load always reads inside the clip, so many can be in flight.
__device__ __forceinline__ float padded_sample(const float* __restrict__ xb, int p, int S) {
  const int j = p - kPad;
  int r = j < 0 ? -j : j;
  r = r >= S ? 2 * (S - 1) - r : r;
  const float v = __ldg(xb + (r < 0 ? 0 : r));
  return j >= S + kPad ? 0.0f : v;
}

__device__ __forceinline__ float to_db(float mel, float scale, float shift, float amin,
                                       float log_ref) {
  const float db = 10.0f * logf(fmaxf(amin, mel)) * kInvLn10 - log_ref;
  return db * scale + shift;
}

// floor(i / d) as one multiply-high, exact for 0 <= i < 2^16 and
// 16 <= d <= 2^12 with m = 2^32 / d + 1 (the error i·(m − 2^32/d) / 2^32
// stays below 1 / d)
__device__ __forceinline__ int div_small(int i, uint32_t m) {
  return static_cast<int>(__umulhi(static_cast<uint32_t>(i), m));
}

struct Bf16Smem {
  size_t fb, mel, span, koff, bars, total;
  int ring;
};

// ring stages first, then the banded filterbank, the mel sum, the span,
// the span offsets of the k16 steps and the mbarriers
__host__ __device__ inline Bf16Smem bf16_smem(int hop, int fb_elems) {
  Bf16Smem l{};
  const size_t fixed = round_up(2 * size_t(fb_elems), 128) + kMelBytes +
                       round_up(2 * size_t(skewed_span(hop)), 128) + sizeof(int) * kSteps +
                       8 * (2 * kMaxRing + 1);
  l.ring = static_cast<int>((kSmemMax - fixed) / kStageBytes);
  if (l.ring > kMaxRing) l.ring = kMaxRing;
  l.fb = size_t(l.ring) * kStageBytes;
  l.mel = l.fb + round_up(2 * size_t(fb_elems), 128);
  l.span = l.mel + kMelBytes;
  l.koff = l.span + round_up(2 * size_t(skewed_span(hop)), 128);
  l.bars = l.koff + sizeof(int) * kSteps;
  l.total = l.bars + 8 * (2 * l.ring + 1);
  return l;
}

// mel[rows of this thread, m0 ..] += P (64 x 64, register A) · fb band
// (64 x N at shared address fbj, K-major core matrices [k/16][n/8][k/8 % 2]
// [n % 8][k % 8]); `rows` is the thread's row 16·warp + lane / 4 of the
// mel sum. The adds of one row come from the lanes of one warp only.
template <int N>
__device__ __forceinline__ void band_product(const uint32_t (&pa)[4][4], uint32_t fbj, float* rows,
                                             int m0, int lane) {
  float d[N / 8][4];
#pragma unroll
  for (int t = 0; t < N / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16<N>(d, pa[s], smem_desc(fbj + s * 16 * N * 2));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  float* r0 = rows + m0 + 2 * (lane % 4);
  float* r8 = r0 + 8 * kMelLd;
#pragma unroll
  for (int t = 0; t < N / 8; ++t) {
    r0[8 * t] += d[t][0];
    r0[8 * t + 1] += d[t][1];
    r8[8 * t] += d[t][2];
    r8[8 * t + 1] += d[t][3];
  }
}

__global__ void __launch_bounds__(kThreadsBf16, 1)
logmel_bf16_kernel(const float* __restrict__ x,              // (B, S)
                   const __nv_bfloat16* __restrict__ basis,  // n_chunks x 16 ring stages
                   const __nv_bfloat16* __restrict__ fb,     // the chunks' bands, packed
                   const int* __restrict__ bands,            // (n_chunks, 3): offset, m0, N
                   const float* __restrict__ scale,          // (224)
                   const float* __restrict__ shift,          // (224)
                   float* __restrict__ out,                  // (B, T, 224)
                   int S, int T, int hop, int n_chunks, int fb_elems, float amin,
                   float log_ref) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Smem L = bf16_smem(hop, fb_elems);
  const int ring = L.ring;
  const uint32_t sbase = smem_addr(smem);
  const uint32_t full = sbase + static_cast<uint32_t>(L.bars);  // + 8 · slot
  const uint32_t empty = full + 8 * ring;                       // + 8 · slot
  const uint32_t fb_bar = empty + 8 * ring;
  const int n_stages = n_chunks * kChunkStages;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);  // every consumer warp
    }
    mbar_init(fb_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kConsumers) {  // ---- producer warp
    if (lane == 0) {
      mbar_expect_tx(fb_bar, 2 * fb_elems);
      bulk_copy(sbase + static_cast<uint32_t>(L.fb), fb, 2 * fb_elems, fb_bar);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(basis);
      int s = 0;
      uint32_t phase = 0;
      for (int g = 0; g < n_stages; ++g, s = s + 1 == ring ? 0 : s + 1, phase ^= s == 0) {
        mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_expect_tx(full + 8 * s, kStageBytes);
        bulk_copy(sbase + s * kStageBytes, src + static_cast<size_t>(g) * kStageBytes, kStageBytes,
                  full + 8 * s);
      }
    }
  } else {  // ---- consumer warpgroup: threads 0 .. 127
    const int warp = threadIdx.x / 32;
    float* mel = reinterpret_cast<float*>(smem + L.mel);
    __nv_bfloat16* span = reinterpret_cast<__nv_bfloat16*>(smem + L.span);
    int* koff = reinterpret_cast<int*>(smem + L.koff);

    // the tile's span of the reflect-padded clip, as bf16, 4 samples a
    // thread and step (hop is a multiple of 16, so 4 never straddle a gap),
    // kU steps in flight a thread (42 steps a thread at hop 320): one
    // 16-byte load a step where the whole span lies inside an aligned clip
    // row, else four reflected scalar loads; no branch inside a batch
    const uint32_t hop_m = 0xFFFFFFFFu / hop + 1;  // div_small by hop
    {
      const float* xb = x + static_cast<size_t>(b) * S;
      const int p0 = t0 * hop;  // the span's first padded sample
      const int quads = span_of(hop) / 4;
      const bool interior = (reinterpret_cast<uintptr_t>(xb) & 15) == 0 && p0 >= kPad &&
                            p0 - kPad + span_of(hop) <= S;
      auto load_span = [&](auto load4) {
        constexpr int kU = 21;
        for (int q0 = threadIdx.x; q0 < quads; q0 += kU * kConsumers) {
          float v[kU][4];
#pragma unroll
          for (int u = 0; u < kU; ++u)
            load4(v[u], q0 + u * kConsumers < quads ? q0 + u * kConsumers : quads - 1);
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int i = 4 * (q0 + u * kConsumers);
            if (q0 + u * kConsumers < quads) {
              *reinterpret_cast<uint2*>(span + i + kSpanSkew * div_small(i, hop_m)) =
                  make_uint2(pack_bf16x2(v[u][0], v[u][1]), pack_bf16x2(v[u][2], v[u][3]));
            }
          }
        }
      };
      if (interior) {
        load_span([&](float (&v)[4], int q) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(xb + p0 - kPad + 4 * q));
          v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
        });
      } else {
        load_span([&](float (&v)[4], int q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = padded_sample(xb, p0 + 4 * q + e, S);
        });
      }
      for (int i = threadIdx.x; i < kTM * kMelLd / 4; i += kConsumers)
        reinterpret_cast<float4*>(mel)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (threadIdx.x < kSteps)
        koff[threadIdx.x] = 16 * threadIdx.x + kSpanSkew * div_small(16 * threadIdx.x, hop_m);
    }
    consumer_sync(kConsumers);

    // lane l points ldmatrix at row 16·warp + l % 8 + 8·(l / 8 % 2) of the
    // tile, k half l / 16: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
    const int arow = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    const uint32_t a_base =
        smem_addr(span) + 2 * (arow * (hop + kSpanSkew) + 8 * (lane >> 4));
    auto load_a = [&](uint32_t (&a)[kStageSteps][4], int st) {
#pragma unroll
      for (int kk = 0; kk < kStageSteps; ++kk)
        ldmatrix_x4(a[kk], a_base + 2 * koff[st * kStageSteps + kk]);
    };
    int rslot = 0;  // the ring slot that the next release frees
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * rslot);
      rslot = rslot + 1 == ring ? 0 : rslot + 1;
    };
    float acc[16][4];
    uint32_t a0[kStageSteps][4], a1[kStageSteps][4], a2[kStageSteps][4];
    int slot = 0;        // the ring slot of the next stage
    uint32_t phase = 0;  // and the parity of its fill
    // stage st of the chunk with A in `a`: its products go out behind the
    // previous stage's, then the stage two back is waited on and freed, and
    // the next stage's A is loaded into that stage's buffer `next`
    auto stage = [&](uint32_t (&a)[kStageSteps][4], uint32_t (&next)[kStageSteps][4], int st) {
      mbar_wait(full + 8 * slot, phase);
      const uint32_t stage_addr = sbase + slot * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageSteps; ++kk)
        wgmma_bf16<128>(acc, a[kk], smem_desc(stage_addr + kk * kStepBytes));
      wgmma_commit();
      if (++slot == ring) slot = 0, phase ^= 1;
      wgmma_wait<2>();
      if (st >= 2) release();
      if (st + 1 < kChunkStages) load_a(next, st + 1);
    };

    float* rows = mel + (16 * warp + lane / 4) * kMelLd;
    for (int j = 0; j < n_chunks; ++j) {
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
      load_a(a0, 0);
      static_assert(kChunkStages % 3 == 1, "the buffer rotation below ends on a0");
      for (int st = 0; st + 1 < kChunkStages; st += 3) {
        stage(a0, a1, st);
        stage(a1, a2, st + 1);
        stage(a2, a0, st + 2);
      }
      stage(a0, a1, kChunkStages - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      release();
      release();

      // power of frequency 4t + lane % 4 of the chunk, rows r and r + 8, is
      // in n8 tile t; k16 step s of the mel product takes tiles 4s .. 4s + 3
      // as k pairs (2c, 2c + 1) and (8 + 2c, 9 + 2c)
      uint32_t pa[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = 4 * s + 2 * h;
          pa[s][2 * h] = pack_bf16x2(acc[t][0] * acc[t][0] + acc[t][1] * acc[t][1],
                                     acc[t + 1][0] * acc[t + 1][0] + acc[t + 1][1] * acc[t + 1][1]);
          pa[s][2 * h + 1] =
              pack_bf16x2(acc[t][2] * acc[t][2] + acc[t][3] * acc[t][3],
                          acc[t + 1][2] * acc[t + 1][2] + acc[t + 1][3] * acc[t + 1][3]);
        }
      if (j == 0) mbar_wait(fb_bar, 0);
      const uint32_t fbj = sbase + static_cast<uint32_t>(L.fb) + 2 * __ldg(bands + 3 * j);
      const int m0 = __ldg(bands + 3 * j + 1);
      switch (__ldg(bands + 3 * j + 2)) {
        case 16: band_product<16>(pa, fbj, rows, m0, lane); break;
        case 32: band_product<32>(pa, fbj, rows, m0, lane); break;
        case 64: band_product<64>(pa, fbj, rows, m0, lane); break;
        default: band_product<128>(pa, fbj, rows, m0, lane); break;
      }
      __syncwarp();  // the next chunk's adds to these rows come from other lanes
    }

    // ---- epilogue: each warp's real rows, dB and affine, 16-byte stores;
    // a lane's 28 float4 go kEpi at a time, so that four warps keep
    // independent logs in flight
    const int r0 = t0 + 16 * warp;
    const int n_rows = T - r0 < 16 ? T - r0 : 16;
    float* orow = out + (static_cast<size_t>(b) * T + r0) * kMels;
    const float* mrow = mel + 16 * warp * kMelLd;
    constexpr int kQuads = 16 * (kMels / 4) / 32;
    constexpr int kEpi = 7;
    static_assert(kQuads % kEpi == 0, "whole batches of a lane's float4");
    for (int i0 = 0; i0 < kQuads; i0 += kEpi) {
      float4 v[kEpi];
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        const int e = lane + 32 * (i0 + u);
        v[u] = *reinterpret_cast<const float4*>(mrow + e / (kMels / 4) * kMelLd + 4 * (e % (kMels / 4)));
      }
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        const int e = lane + 32 * (i0 + u);
        const int c4 = e % (kMels / 4);
        if (e / (kMels / 4) < n_rows) {
          const float4 sc = __ldg(reinterpret_cast<const float4*>(scale) + c4);
          const float4 sh = __ldg(reinterpret_cast<const float4*>(shift) + c4);
          v[u].x = to_db(v[u].x, sc.x, sh.x, amin, log_ref);
          v[u].y = to_db(v[u].y, sc.y, sh.y, amin, log_ref);
          v[u].z = to_db(v[u].z, sc.z, sh.z, amin, log_ref);
          v[u].w = to_db(v[u].w, sc.w, sh.w, amin, log_ref);
          reinterpret_cast<float4*>(orow)[e] = v[u];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
logmel_f32_kernel(const float* __restrict__ x,       // (B, S)
                  const float* __restrict__ basis,   // (1024, kBasisLd)
                  const float* __restrict__ melfb,   // (kNC·kChunks, 224)
                  const float* __restrict__ scale,   // (224)
                  const float* __restrict__ shift,   // (224)
                  float* __restrict__ out,           // (B, T, 224)
                  int S, int T, int hop, float amin, float log_ref) {
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
    const float* xb = x + static_cast<size_t>(b) * S;
    for (int i = threadIdx.x; i < span; i += kThreads) ws[i] = padded_sample(xb, t0 * hop + i, S);
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
    const float* fbp = melfb + static_cast<size_t>(j) * kNC * kMels + lane;
#pragma unroll 4
    for (int kk = 0; kk < kNC; ++kk) {
      float w[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) w[c] = __ldg(fbp + kk * kMels + 32 * c);
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
            to_db(macc[r][c], __ldg(scale + m), __ldg(shift + m), amin, log_ref);
      }
    }
  }
}

cudaError_t launch_bf16(const float* x, const __nv_bfloat16* basis, const __nv_bfloat16* fb,
                        const int* bands, const float* scale, const float* shift, float* out,
                        int B, int S, int T, int hop, int n_chunks, int fb_elems, float amin,
                        float log_ref, cudaStream_t stream) {
  static size_t smem_done[hopper::kMaxDevices] = {};
  const cudaError_t err = hopper::allow_smem(logmel_bf16_kernel, kSmemMax, smem_done);
  if (err != cudaSuccess) return err;
  const Bf16Smem L = bf16_smem(hop, fb_elems);
  if (L.ring < 2 || L.total > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  const dim3 grid((T + kTM - 1) / kTM, B);
  logmel_bf16_kernel<<<grid, kThreadsBf16, L.total, stream>>>(
      x, basis, fb, bands, scale, shift, out, S, T, hop, n_chunks, fb_elems, amin, log_ref);
  return cudaGetLastError();
}

}  // namespace

// C entry point: returns the cudaError_t of the launch (0 on success).
// x is the waveform (B, S) f32 (the kernels reflect-pad it themselves); out
// is (B, 1 + S / hop, 224) f32. use_bf16: basis and fb are the packed bf16
// operands of kernels/logmel.py (n_chunks live chunks of 64 frequencies,
// fb_elems elements of banded filterbank, `bands` (n_chunks, 3) int32 of
// band offset, first mel and width); else they are the dense f32 basis
// (1024, 1088) and filterbank (544, 224), and bands, n_chunks and fb_elems
// are not read.
extern "C" int conette_logmel(const void* x, const void* basis, const void* fb, const void* bands,
                              const void* scale, const void* shift, void* out, int B, int S,
                              int T, int hop, int n_chunks, int fb_elems, int use_bf16,
                              float amin, float log_ref, void* stream) {
  if (B < 1 || S <= kPad || hop < 16 || hop % 16 || T != 1 + S / hop) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16) {
    if (n_chunks < 1 || n_chunks > kMaxChunks || fb_elems < 1 || fb_elems % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(basis),
                       static_cast<const __nv_bfloat16*>(fb), static_cast<const int*>(bands),
                       static_cast<const float*>(scale), static_cast<const float*>(shift),
                       static_cast<float*>(out), B, S, T, hop, n_chunks, fb_elems, amin, log_ref,
                       s);
  }
  const dim3 grid((T + kTM - 1) / kTM, B);
  const size_t smem = round_up(sizeof(float) * span_of(hop), 128) + sizeof(float) * kTM * kNC;
  static size_t smem_done[hopper::kMaxDevices] = {};
  const cudaError_t err = hopper::allow_smem(logmel_f32_kernel, smem, smem_done);
  if (err != cudaSuccess) return err;
  logmel_f32_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(out), S, T, hop, amin, log_ref);
  return cudaGetLastError();
}
