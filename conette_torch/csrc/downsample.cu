// The downsample seam between two ConvNeXt stages, bf16 in and out:
//
//   out[b, t2, f2, :] = bias + sum_{i,j in {0,1}} LN(x[b, 2t2+i, 2f2+j, :]) · W[i, j]
//
// i.e. LayerNorm over C (f32 statistics, rounded to bf16) followed by
// Conv2d(k=2, s=2) from C to 2C (bf16 weights, f32 accumulation, f32 bias,
// rounded to bf16). Replaces the TPU kernel
// conette_tpu/ops/pallas/downsample.py: fused_downsample_padded (body
// _fused_downsample_kernel), without its stage padding, one-hot frequency
// selection or VMEM plans: the input is contiguous NHWC (B, T, F, C) at its
// real extents, an odd T floors (the last row is never read), F must be even.
//
// What bounds it on the H100: a GEMM of M = B·T/2·F/2 output pixels, K = 4C,
// N = 2C, whose A rows are input pixels normalised on the fly. At batch 8
// (10 s clips) seams 1 and 2 are bound by their activation bytes (32.5 and
// 16.3 MB in + out: 0.0098 and 0.0050 ms) and seam 3 by its operations
// (0.0041 ms). What a kernel meets first is elsewhere: every 64-pixel tile
// has to see all of W (147 KB, 590 KB and 2.36 MB as bf16), so a launch
// reads about 65 MB of weights from L2 at every seam (441 × 147 KB,
// 111 × 590 KB, 28 × 2.36 MB; the WMMA kernel this replaced read about
// 130 MB a seam); the LayerNorm runs on the CUDA cores, 4C values a pixel;
// and a tile's loads, LayerNorm and products depend on one another, so a
// CTA that does them in turn leaves each unit idle most of the time
// (scripts/_seam_kernel_phases.py times the parts and traces the steps).
//
// The design: one call is two launches on the caller's stream.
//   pack  seam_pack_kernel casts W (2, 2, C, 2C) = (4C, 2C) f32 to bf16 in
//         wgmma's K-major core-matrix order without swizzle, [k/16][n/8]
//         [k/8 % 2][n % 8][k % 8] (pack_seam_weights is its plain version),
//         so a work item's columns of one k16 step are one contiguous run;
//   seam  seam_kernel: one persistent CTA an SM walks work items of 64
//         consecutive output pixels (wgmma's M) × one slice of NS output
//         columns (192, 128, 96 or 64: the wrapper's seam_plan takes slices
//         of 192 where the tiles fill the card, else as many as it holds).
//         K is never split, so there is no cross-CTA sum and two runs give
//         the same bits. Each 2×2 patch position q = 2i + j of an item is a
//         step of one stream through three roles, warp-specialised:
//         - a producer warp streams the item's W slice through a ring of
//           shared-memory stages (KS k16 steps each) by cp.async.bulk
//           copies that complete on the stage's "full" mbarrier; where the
//           ring holds a whole slice and all of a CTA's items share it
//           (seam 1 at batch 8: W is 147 KB), it is loaded once and kept;
//         - two LayerNorm warpgroups copy the position's 64 input pixels
//           (b, 2t2+i, 2f2+j) with 16-byte cp.async, four lanes a pixel,
//           straight into an A buffer in the core-matrix order wgmma reads
//           (a_off), NA - 1 positions ahead, then normalise them in place
//           (two-pass f32 statistics by shuffles over the pixel's lanes,
//           rounded to bf16) and mark the buffer full. The eight lanes of a
//           quarter warp take rows that a_off puts 16 bytes apart, so no
//           shared-memory access meets a bank twice. The A operand is
//           never written to device memory;
//         - one MMA warpgroup multiplies each full position on wgmma
//           m64nNSk16, bf16 in, f32 accumulate in registers (NS/2 a
//           thread), both operands from shared memory by descriptor; frees
//           the ring stage and the A buffer as its groups finish; and after
//           position 3 adds the f32 bias, rounds to bf16 through shared
//           memory and writes the item's rows with 16-byte stores, masking
//           the ragged last tile, while the other roles run ahead into the
//           next item.
// The rounding points are those of the plain PyTorch version
// (conette_torch/kernels/downsample.py::downsample_reference), so the two
// differ only by f32 summation order.
//
// C entry point: conette_downsample(x, ln_w, ln_b, w, bias, work, out, B, T,
// F, C, slices, ctas, device, eps, stream), 7 pointers, 7 ints, 1 float;
// ln_w, ln_b, w and bias f32 as the model holds them; work is a bf16 buffer
// of 8·C² for the packed weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = kTileRows;  // output pixels a CTA

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int C, int NS>
struct SeamCfg {
  static constexpr int N = 2 * C;
  static constexpr int KS = C == 384 ? 4 : 2;        // k16 steps a ring stage
  static constexpr int SPP = C / 16 / KS;              // ring stages a patch position
  static constexpr int STAGES = 4 * SPP;               // ring stages a work item: all of K
  static constexpr int STAGE_BYTES = KS * 16 * NS * 2;
  // warps: one warpgroup of products, two of LayerNorm, one producer warp
  static constexpr int MMA_THREADS = 128;
  static constexpr int LN_THREADS = 256;
  static constexpr int THREADS = MMA_THREADS + LN_THREADS + 32;
  // LayerNorm: 8 pixels a warp, lanes l, l + 8, l + 16, l + 24 on pixel
  // l % 8, each on GPL groups of 8 channels: the tile's 64 pixels at once
  static constexpr int GPL = C / 32;
  static constexpr size_t A_BYTES = size_t(kRows) * C * 2;
  // A buffers: a position's input copies are issued NA - 1 positions ahead
  // of its products
  static constexpr int NA = C == 384 ? 2 : 4;
  static constexpr int O_ROW = 2 * NS + 16;          // bytes a staged output row
  static constexpr size_t O_BYTES = size_t(kRows) * O_ROW;
  static constexpr size_t LN_BYTES = 8 * C;          // ln_w, ln_b (f32)
  static constexpr size_t BAR_BYTES = 8 * (2 * STAGES + 2 * NA);  // at most
  static constexpr int RING_FIT =
      int((232448 - NA * A_BYTES - O_BYTES - LN_BYTES - BAR_BYTES) / STAGE_BYTES);
  // as many stages as fit, up to a whole item's: then a CTA whose items
  // share one slice loads W once and keeps it (seam_kernel's `resident`)
  static constexpr int RING = RING_FIT < STAGES ? RING_FIT : STAGES;
  static constexpr size_t A_OFF = size_t(RING) * STAGE_BYTES;
  static constexpr size_t O_OFF = A_OFF + NA * A_BYTES;
  static constexpr size_t LN_OFF = O_OFF + O_BYTES;
  static constexpr size_t BAR_OFF = LN_OFF + LN_BYTES;
  static constexpr size_t SMEM = BAR_OFF + BAR_BYTES;
  static_assert(SPP * KS * 16 == C, "a patch position is whole ring stages");
  static_assert(LN_THREADS / 32 * 8 == kRows, "one pixel a lane quad");
  static_assert(RING >= 2 && SMEM <= 232448, "the ring and the A buffers fit");
  static_assert(NS % 16 == 0 && N % NS == 0, "whole slices of n8 pairs");
};

// A persistent CTA takes work items blockIdx.x, blockIdx.x + gridDim.x, ...
// of tiles × slices (slice fastest): item k is rows 64·(k / slices) .. and
// columns NS·(k % slices) .. of the output. Its positions run as one
// stream, pc = 4·(item count) + q, through three roles:
//   producer warp  W's stages for each item through the ring;
//   LN warpgroups  copy position pc + NA - 1's pixels into its A buffer
//                  (once the products of the position that last used it are
//                  done), normalise position pc in place, and mark it full;
//   MMA warpgroup  multiplies each full position into the accumulators,
//                  frees its buffer, and after position 3 of an item adds the
//                  bias and stores the item's 64 × NS outputs.
template <int C, int NS>
__global__ void __launch_bounds__(SeamCfg<C, NS>::THREADS, 1)
seam_kernel(const __nv_bfloat16* __restrict__ x,      // (B, T, F, C)
            const float* __restrict__ ln_w,           // (C)
            const float* __restrict__ ln_b,           // (C)
            const __nv_bfloat16* __restrict__ wpack,  // pack_seam_weights order
            const float* __restrict__ bias,           // (2C)
            __nv_bfloat16* __restrict__ out,          // (B, T/2, F/2, 2C)
            int n_out, int T, int F, int slices, float eps) {
  using K = SeamCfg<C, NS>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  const uint32_t ring = sbase;
  const uint32_t full = sbase + K::BAR_OFF;    // + 8 · slot
  const uint32_t empty = full + 8 * K::RING;   // + 8 · slot
  const uint32_t a_full = empty + 8 * K::RING;  // + 8 · buffer
  const uint32_t a_empty = a_full + 8 * K::NA;  // + 8 · buffer
  const uint32_t a_base = sbase + K::A_OFF;
  const int n_ctas = static_cast<int>(gridDim.x);
  const int n_items = (n_out + kRows - 1) / kRows * slices;
  const int my_items = (n_items - static_cast<int>(blockIdx.x) + n_ctas - 1) / n_ctas;
  auto item_of = [&](int i) { return static_cast<int>(blockIdx.x) + i * n_ctas; };
  // the ring holds the whole W slice and every item of the CTA has the same
  // slice: the producer fills the ring once and the products never free it
  const bool resident = K::RING == K::STAGES && n_ctas % slices == 0;

  float* lns = reinterpret_cast<float*>(smem + K::LN_OFF);  // ln_w, then ln_b
  for (int i = threadIdx.x; i < C; i += K::THREADS) {
    lns[i] = __ldg(ln_w + i);
    lns[C + i] = __ldg(ln_b + i);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < K::RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, K::MMA_THREADS / 32);
    }
    for (int b = 0; b < K::NA; ++b) {
      mbar_init(a_full + 8 * b, K::LN_THREADS / 32);
      mbar_init(a_empty + 8 * b, K::MMA_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= K::MMA_THREADS + K::LN_THREADS) {  // ---- producer warp
    if (lane == 0) {
      int g = 0;  // ring stage counter over the CTA's items
      for (int i = 0; i < (resident && my_items > 0 ? 1 : my_items); ++i) {
        // k16 step kb of the packed W is 16·N values, [N/8][2][8][8]; the
        // item's columns are the 16·NS of them from 16·n0 on
        const __nv_bfloat16* src = wpack + static_cast<size_t>(item_of(i) % slices) * NS * 16;
        for (int st = 0; st < K::STAGES; ++st, ++g) {
          const int s = g % K::RING;
          mbar_wait(empty + 8 * s, ((g / K::RING) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, K::STAGE_BYTES);
#pragma unroll
          for (int kk = 0; kk < K::KS; ++kk)
            bulk_copy(ring + s * K::STAGE_BYTES + kk * NS * 32,
                      src + static_cast<size_t>(st * K::KS + kk) * 16 * K::N, NS * 32,
                      full + 8 * s);
        }
      }
    }
    return;
  }

  if (threadIdx.x >= K::MMA_THREADS) {  // ---- LayerNorm warpgroups
    const int lw = (threadIdx.x - K::MMA_THREADS) / 32;
    // the thread's pixel is row m = 8·lw + lane % 8 of a tile, and its
    // channels the groups lane / 8 + 4·j of 8: the eight lanes of a
    // quarter warp take eight consecutive rows, which a_off puts 16 bytes
    // apart, so their 16-byte shared-memory accesses meet no bank twice
    const int m = 8 * lw + lane % 8;
    auto chan_of = [&](int j) { return (lane / 8 + 4 * j) * 8; };
    const int T2 = T / 2, F2 = F / 2;
    const int n_pos = 4 * my_items;

    // position pc's input pixels into its A buffer, in a_off order, by
    // 16-byte cp.async; a pixel past the last one reads zeros
    auto copy_in = [&](int pc) {
      const int q = pc % 4;
      const int g = item_of(pc / 4) / slices * kRows + m;
      const bool valid = g < n_out;
      const __nv_bfloat16* src = x;
      if (valid) {
        const int b = g / (T2 * F2);
        const int r = g - b * (T2 * F2);
        const int t2 = r / F2;
        src += static_cast<size_t>((b * T + 2 * t2 + (q >> 1)) * F + 2 * (r - t2 * F2) + (q & 1)) * C;
      }
      const uint32_t a = a_base + (pc % K::NA) * K::A_BYTES;
#pragma unroll
      for (int j = 0; j < K::GPL; ++j) {
        const int c = chan_of(j);
        cp_async16(a + 2 * a_off(m, c), src + (valid ? c : 0), valid ? 16 : 0);
      }
    };

    // the sum over a pixel's four lanes
    auto pixel_sum = [](float v) {
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      return v + __shfl_xor_sync(0xffffffffu, v, 16);
    };

    // one copy group a position, empty past the last, so that before
    // position pc's LayerNorm exactly NA - 2 groups follow its own
    for (int pc = 0; pc < K::NA - 1; ++pc) {
      if (pc < n_pos) copy_in(pc);
      cp_async_commit();
    }
    for (int pc = 0; pc < n_pos; ++pc) {
      // LayerNorm of position pc in place over the chunks this thread
      // copied: each chunk read once, the mean, the variance about it, the
      // normalised values written back
      cp_async_wait<K::NA - 2>();
      __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + K::A_OFF) +
                         (pc % K::NA) * (kRows * C);
      uint4 raw[K::GPL];
      float v[8];
#pragma unroll
      for (int j = 0; j < K::GPL; ++j) raw[j] = *reinterpret_cast<const uint4*>(a + a_off(m, chan_of(j)));
      // each chunk's 8 values summed as a tree, so the adds do not wait on
      // one another down a chain of the lane's C / 4 values
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < K::GPL; ++j) {
        unpack_bf16x8(raw[j], v);
        sum += ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
      }
      const float mean = pixel_sum(sum) / C;
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < K::GPL; ++j) {
        unpack_bf16x8(raw[j], v);
        float d[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = (v[e] - mean) * (v[e] - mean);
        sq += ((d[0] + d[1]) + (d[2] + d[3])) + ((d[4] + d[5]) + (d[6] + d[7]));
      }
      const float rstd = rsqrtf(pixel_sum(sq) / C + eps);
#pragma unroll
      for (int j = 0; j < K::GPL; ++j) {
        const int c = chan_of(j);
        const float4* w4 = reinterpret_cast<const float4*>(lns + c);
        const float4* b4 = reinterpret_cast<const float4*>(lns + C + c);
        const float4 wa = w4[0], wb = w4[1], ba = b4[0], bb = b4[1];
        const float lw8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const float lb8[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
        unpack_bf16x8(raw[j], v);
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const __nv_bfloat162 y = __floats2bfloat162_rn((v[e] - mean) * rstd * lw8[e] + lb8[e],
                                                         (v[e + 1] - mean) * rstd * lw8[e + 1] + lb8[e + 1]);
          packed[e / 2] = *reinterpret_cast<const uint32_t*>(&y);
        }
        *reinterpret_cast<uint4*>(a + a_off(m, c)) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      fence_proxy_async();  // the stores, to the products' reads
      __syncwarp();
      if (lane == 0) mbar_arrive(a_full + 8 * (pc % K::NA));
      // the copies of position pc + NA - 1, once the products of the
      // position before it in its buffer are done
      const int pl = pc + K::NA - 1;
      if (pl < n_pos) {
        if (pl >= K::NA) mbar_wait(a_empty + 8 * (pl % K::NA), ((pl / K::NA) - 1) & 1);
        copy_in(pl);
      }
      cp_async_commit();
    }
    return;
  }

  // ---- MMA warpgroup: threads 0 .. 127
  const int warp = threadIdx.x / 32;
  auto release = [&](int stage_it) {
    if (resident) return;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (stage_it % K::RING));
    __syncwarp();
  };
  // a k16 step of an A buffer (64 rows) is 2 KB
  constexpr uint32_t kA16 = kRows * 16 * 2;
  int it = 0;  // ring stage counter over the CTA's items
  for (int i = 0; i < my_items; ++i) {
    float acc[NS / 8][4];
#pragma unroll
    for (int j = 0; j < NS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    for (int q = 0; q < 4; ++q) {
      // acc += LN(position q's pixels) · W[q·C : (q+1)·C, n0 : n0 + NS]
      const int pc = 4 * i + q;
      mbar_wait(a_full + 8 * (pc % K::NA), (pc / K::NA) & 1);
      const uint32_t a_addr = a_base + (pc % K::NA) * K::A_BYTES;
      // the position's groups all go out before any is waited on; a
      // stage is released early only where the ring is shorter than a
      // position and the producer needs its slot
      int rel = it;
      for (int st = 0; st < K::SPP; ++st, ++it) {
        const int s = it % K::RING;
        if (!resident || i == 0) mbar_wait(full + 8 * s, (it / K::RING) & 1);
        const uint32_t stage = ring + s * K::STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < K::KS; ++kk)
          wgmma_bf16<NS>(acc, smem_desc(a_addr + (st * K::KS + kk) * kA16),
                         smem_desc(stage + kk * NS * 32));
        wgmma_commit();
        if constexpr (K::RING < K::SPP) {
          if (st >= K::RING - 1) {
            wgmma_wait<K::RING - 1>();
            release(rel++);
          }
        }
      }
      wgmma_wait<0>();
      while (rel < it) release(rel++);
      __syncwarp();
      if (lane == 0) mbar_arrive(a_empty + 8 * (pc % K::NA));  // the buffer is free
    }
    fence_regs(acc);
    // bf16(acc + bias) into the staging rows (2·NS + 16 bytes apart, so a
    // warp's stores fall on distinct banks), then each row's NS columns to
    // memory with 16-byte stores
    const int item = item_of(i);
    const int pix0 = item / slices * kRows;
    const int n0 = item % slices * NS;
    const int gq = lane / 4;
    const int qd = lane % 4;
    unsigned char* os = smem + K::O_OFF;
    consumer_sync(K::MMA_THREADS);  // the previous item's rows are out
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int c = j * 8 + 2 * qd;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + n0 + c));
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<__nv_bfloat162*>(os + (16 * warp + gq + 8 * half) * K::O_ROW + c * 2) =
            __floats2bfloat162_rn(acc[j][2 * half] + bb.x, acc[j][2 * half + 1] + bb.y);
    }
    consumer_sync(K::MMA_THREADS);
    for (int k = threadIdx.x; k < kRows * NS / 8; k += K::MMA_THREADS) {
      const int row = k / (NS / 8);
      const int c8 = k % (NS / 8);
      const size_t g = static_cast<size_t>(pix0) + row;
      if (g >= static_cast<size_t>(n_out)) break;  // k grows with the row
      *reinterpret_cast<uint4*>(out + g * K::N + n0 + c8 * 8) =
          *reinterpret_cast<const uint4*>(os + row * K::O_ROW + c8 * 16);
    }
  }
}

// W (4C, 2C) f32 as bf16 in [k/16][n/8][k/8 % 2][n % 8][k % 8] order
// (pack_seam_weights is its plain version). One thread writes 8 values.
__global__ void seam_pack_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wpack,
                                 int n_rows, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int nr = i % 8;
  const int kh = (i / 8) % 2;
  const int ng = (i / 16) % (N / 8);
  const int k0 = (i / (2 * N)) * 16 + kh * 8;
  const int n = ng * 8 + nr;
  uint32_t packed[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(__ldg(w + static_cast<size_t>(k0 + e) * N + n),
                                                   __ldg(w + static_cast<size_t>(k0 + e + 1) * N + n));
    packed[e / 2] = *reinterpret_cast<const uint32_t*>(&b);
  }
  reinterpret_cast<uint4*>(wpack)[i] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

template <int C, int NS>
cudaError_t launch_slices(const __nv_bfloat16* x, const float* ln_w, const float* ln_b,
                          const __nv_bfloat16* wpack, const float* bias, __nv_bfloat16* out,
                          int n_out, int T, int F, int ctas, float eps, cudaStream_t stream) {
  using K = SeamCfg<C, NS>;
  static size_t smem_done[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::allow_smem(seam_kernel<C, NS>, K::SMEM, smem_done);
  if (err != cudaSuccess) return err;
  seam_kernel<C, NS><<<ctas, K::THREADS, K::SMEM, stream>>>(x, ln_w, ln_b, wpack, bias, out, n_out,
                                                            T, F, K::N / NS, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* x, const void* ln_w, const void* ln_b, const void* w,
                   const void* bias, void* work, void* out, int n_out, int T, int F, int n_slices,
                   int ctas, float eps, cudaStream_t stream) {
  const int n_rows = C * C;  // 8-value rows of the packed (4C, 2C)
  __nv_bfloat16* wpack = static_cast<__nv_bfloat16*>(work);
  seam_pack_kernel<<<(n_rows + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(w), wpack,
                                                             n_rows, 2 * C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* lw = static_cast<const float*>(ln_w);
  const auto* lb = static_cast<const float*>(ln_b);
  const auto* bb = static_cast<const float*>(bias);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  switch (2 * C / n_slices) {
    case 192:
      return launch_slices<C, 192>(xb, lw, lb, wpack, bb, ob, n_out, T, F, ctas, eps, stream);
    case 128:
      if constexpr (2 * C % 128 == 0)
        return launch_slices<C, 128>(xb, lw, lb, wpack, bb, ob, n_out, T, F, ctas, eps, stream);
      break;
    case 96:
      return launch_slices<C, 96>(xb, lw, lb, wpack, bb, ob, n_out, T, F, ctas, eps, stream);
    case 64:
      return launch_slices<C, 64>(xb, lw, lb, wpack, bb, ob, n_out, T, F, ctas, eps, stream);
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point: returns the cudaError_t of the launches (0 on success).
// `work` is a bf16 buffer of 8·C² for the packed weights; `slices` cuts the
// 2C output columns into slices of 192, 128, 96 or 64; `ctas` persistent
// CTAs share the tiles × slices work items; the launches go to CUDA device
// `device` (the caller's current device is kept).
extern "C" int conette_downsample(const void* x, const void* ln_w, const void* ln_b,
                                  const void* w, const void* bias, void* work, void* out, int B,
                                  int T, int F, int C, int n_slices, int ctas, int device,
                                  float eps, void* stream) {
  const int n_out = B * (T / 2) * (F / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out <= 0 || F % 2 || n_slices < 1 || (2 * C) % n_slices || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (C) {
    case 96:
      err = launch<96>(x, ln_w, ln_b, w, bias, work, out, n_out, T, F, n_slices, ctas, eps, s);
      break;
    case 192:
      err = launch<192>(x, ln_w, ln_b, w, bias, work, out, n_out, T, F, n_slices, ctas, eps, s);
      break;
    case 384:
      err = launch<384>(x, ln_w, ln_b, w, bias, work, out, n_out, T, F, n_slices, ctas, eps, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

// The message of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* conette_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
