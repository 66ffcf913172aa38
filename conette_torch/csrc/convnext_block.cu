// One whole ConvNeXt block, bf16 in and out:
//
//   out = x + scale * (W2 · GELU(W1 · LN(dwconv7x7(x) + b_dw) + b1) + b2)
//
// Replaces the TPU kernel conette_tpu/ops/pallas/convnext_block.py:
// fused_convnext_block_padded (body _fused_block_kernel). It ports the math,
// not the Mosaic tiling: no (8, 128) stage padding, no VMEM plans; the
// kernels take contiguous NHWC (B, T, F, C) bf16 at its real extents.
//
// What bounds it on the H100: per pixel the block does 2·C·2H + 98·C
// operations (H = 4C) against 4·C bytes of activations, so at batch 8 every
// stage's bound is the tensor cores' (about 0.017 ms). What the kernels meet
// first is elsewhere (scripts/_block_kernel_phases.py times the parts):
//   - each 64-pixel tile has to see all 16·C² bytes of W1 and W2 (147 KB at
//     C = 96, 9.4 MB at C = 768): about 260 MB through L2 a launch at every
//     stage of a 10 s clip, whatever C is. The MLP streams it at 2-4 TB/s;
//   - two parts run on the CUDA cores and are bound by instruction issue:
//     the depthwise stencil (phase A, 49·C multiply-adds a pixel, with the
//     bf16 unpacking and addressing around them) and the exact-erf GELU of
//     4·C values a pixel. They weigh most at stages 1 and 2;
//   - at C = 768 the 28 tiles of batch 8 leave most SMs idle unless the
//     hidden layer is split (below).
//
// The design: one call is three or four launches on the caller's stream.
//   pack     block_pack_kernel casts W1 and W2 (f32) to bf16 in the ring's
//            order (pack_block_weights is its plain version): for each
//            64-wide hidden chunk, the W1 chunk (K = C) then the W2 chunk
//            (K = 64), each as 8x8 core matrices ([k/16][n/8][k/8 % 2]
//            [n % 8][k % 8]), so a ring stage is one contiguous copy and
//            each core matrix 128 contiguous bytes: wgmma's K-major layout
//            without swizzle. It casts the depthwise weights and the layer
//            scale to bf16 behind them;
//   phase A  block_dwln_kernel computes the 49-tap depthwise stencil in f32
//            from 16-byte loads (8 channels a lane, a team of 16 or 32 lanes
//            a pixel), in runs of 8, 4 or 2 neighbours along F that share
//            each input load over up to 7 taps, + b_dw, and LayerNorm with
//            f32 statistics (two-pass, by team shuffles). Y goes to a
//            global buffer as bf16, in the layout the MLP's wgmmas read from
//            shared memory, 128·C contiguous bytes a 64-row tile. It is a
//            launch of its own, on CTAs of 8 to 64 pixels over the whole
//            card: inside the MLP's CTAs it ran before their products on
//            the same warps, about as long as the MLP at stages 1 and 4, and
//            at stage 4 every split CTA of a tile repeated it;
//   MLP      convnext_block_kernel: a CTA owns 64 consecutive pixels
//            (wgmma's M), so each weight byte serves 64 pixels. One bulk
//            copy brings the tile's Y into shared memory, then the weights
//            stream through a ring of RING stages (6, 8, 8, 4 at C = 96,
//            192, 384, 768: what shared memory holds beside Y and G), each
//            stage one cp.async.bulk of 128·C/P bytes (P = 2 at C = 96, 4
//            above; a chunk is 2·P stages) that completes on the stage's
//            "full" mbarrier; every consumer warp arrives on the stage's
//            "empty" mbarrier when its warpgroup's wgmmas are done with it.
//            A producer warp issues the copies; at C = 768, where the
//            accumulators take the whole register file, consumer thread 0
//            issues each refill as its warp releases the stage. No warp
//            loads a weight from global memory. NWG consumer warpgroups (1,
//            1, 2, 4 at C = 96, 192, 384, 768) run wgmma m64nNk16, bf16 in,
//            f32 accumulate, both operands from shared memory by descriptor:
//            Hc = Y · W1[:, chunk], the warpgroup's 64/NWG columns; + b1,
//            rounded to bf16, exact-erf GELU in f32, rounded to bf16 into a
//            double-buffered G[64][64] in shared memory, so GELU(Hc) is
//            shared between the warpgroups; one named barrier over the
//            consumers; then Z[:, the warpgroup's C/NWG columns] +=
//            G · W2[chunk, :], Z in registers (C/NWG/2 floats a thread: 48
//            or 96) for the whole CTA. Each ring stage is one wgmma group;
//            a stage is released once the next one's group is issued and
//            its own is done;
//   split    where the tiles leave the card idle (C = 768 at batch 8: 28
//            tiles), the hidden layer's chunks are split over S CTAs
//            (grid.y, chosen by the wrapper's block_plan: as many as one
//            wave holds). Each writes its Z as f32 partials to a scratch
//            buffer, and block_reduce_kernel sums the S partials in split
//            order, so the result is the same from run to run, and applies
//            the epilogue;
//   epilogue with S = 1 the MLP kernel itself: t = scale · (z + b2) goes to
//            shared memory as bf16 (over Y and G), then out = x + t is
//            written 16 bytes a thread, each row of the tile contiguous.
// Registers: the cap (MAX_REGS) lets MIN_CTAS CTAs share an SM, the
// register file going to warps in groups of four. The products are this
// kernel's own; no library GEMM is called. The values are rounded to bf16
// at the same points as the plain PyTorch version
// (conette_torch/kernels/convnext_block.py::convnext_block_reference), so
// the two differ only by f32 summation order.
//
// C entry point: conette_convnext_block(x, dw_w, dw_b, ln_w, ln_b, w1, w2,
// b1, b2, scale, work, y, out, partial, B, T, F, C, S, eps, stream), 14
// pointers, 5 ints, 1 float; the parameters f32 as the model holds them;
// work, y and partial are the wrapper's scratch buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 64;    // pixels per CTA
constexpr int kHC = 64;      // hidden-layer chunk

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

template <int W>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers and bulk copies take 32-bit shared-memory addresses
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumer_sync(int n_threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(n_threads) : "memory");
}

// Makes the threads' shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from touching accumulators while a wgmma owns them.
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8x8 core matrices of 128 contiguous bytes, the next k half 128 bytes on
// (leading byte offset), the next 8 rows of M or N 256 bytes on (stride
// byte offset); all three fields in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// D[64][N] += A[64][16] · B[16][N], bf16 in, f32 accumulate; d[j][0..3] is
// the thread's (row, col), (row, col + 1), (row + 8, col), (row + 8, col + 1)
// of n8 tile j, with row = 16 · (warp % 4) + lane / 4, col = 8j + 2 · (lane % 4).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 8][4], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[2][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[12][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[24][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "l"(da), "l"(db), "r"(1));
}

// Element offset of (row m, column k) in a 64-row A tile (Y or G): 8x8 core
// matrices [k/16][m/8][k/8 % 2][m % 8][k % 8], the same order as the packed
// weights with m in place of n.
__device__ __forceinline__ int a_off(int m, int k) {
  return ((((k >> 4) * (kRows / 8) + (m >> 3)) * 2 + ((k >> 3) & 1)) * 8 + (m & 7)) * 8 + (k & 7);
}

template <int C>
struct Cfg {
  static constexpr int H = 4 * C;
  static constexpr int NCH = H / kHC;                     // hidden chunks
  static constexpr int NWG = C <= 192 ? 1 : C / 192;       // consumer warpgroups
  static constexpr int P = C == 96 ? 2 : 4;                // ring stages per half chunk
  static constexpr int CONSUMERS = 128 * NWG;
  // at C = 768 the four warpgroups' accumulators (96 a thread, and wgmma
  // m64n192 wants 122 registers) take the whole register file: no room for
  // a producer warp, so consumer thread 0 issues the copies
  static constexpr bool PRODUCER_WARP = NWG < 4;
  static constexpr int THREADS = CONSUMERS + (PRODUCER_WARP ? 32 : 0);
  static constexpr int STAGE_BYTES = 128 * C / P;          // 2·C·64 bytes / P
  // weight ring stages: as many as shared memory holds beside Y and G at
  // MIN_CTAS CTAs an SM, up to 8
  static constexpr int RING = C == 96 ? 6 : (C == 768 ? 4 : 8);
  static constexpr int KB1 = C / P / 16;                   // k16 steps in a W1 stage
  static constexpr int KB2 = kHC / P / 16;                 // k16 steps in a W2 stage
  static constexpr int N1 = kHC / NWG;                     // Hc columns a warpgroup
  static constexpr int N2 = C / NWG;                       // Z columns a warpgroup
  static constexpr int MIN_CTAS = C == 96 ? 3 : (C == 192 ? 2 : 1);  // resident on an SM
  // registers a thread such that MIN_CTAS CTAs fit an SM: the register
  // file holds 65536, handed out to warps in groups of four
  static constexpr int WARP_SLOTS = (THREADS / 32 * MIN_CTAS + 3) / 4 * 4;
  static constexpr int MAX_REGS = 65536 / (WARP_SLOTS * 32) / 8 * 8;
  static constexpr size_t RING_OFF = 0;
  static constexpr size_t Y_OFF = RING_OFF + size_t(RING) * STAGE_BYTES;
  static constexpr size_t G_OFF = Y_OFF + size_t(kRows) * C * 2;
  static constexpr size_t BAR_OFF = G_OFF + 2 * kRows * kHC * 2;
  // full and empty barriers of each ring slot, then the Y tile's barrier
  static constexpr size_t SMEM = BAR_OFF + (2 * RING + 1) * sizeof(uint64_t);
  static constexpr uint32_t Y_BYTES = kRows * C * 2;
  static_assert(N1 % 16 == 0 && N2 % 16 == 0, "n8 tiles go in pairs");
  static_assert(KB1 * 16 * P == C && KB2 * 16 * P == kHC, "stages hold whole k16 steps");
};

// Phase A's lanes: a team of TEAM lanes a pixel, C / 8 groups of 8
// channels over them, evenly where C allows (1 group a lane for 12 of 16
// at C = 96, 24 of 32 at C = 192; 3 groups a lane at C = 384 and 768);
// eight teams a CTA.
template <int C>
struct DwCfg {
  static constexpr int TEAM = C == 192 || C == 768 ? 32 : 16;
  static constexpr int TEAMS = 8;
  static constexpr int THREADS = TEAM * TEAMS;
  static constexpr int GPL = (C / 8 + TEAM - 1) / TEAM;    // 8-channel groups a lane
};

// 768 bf16 zeros: what phase A reads for a neighbour outside the map
__device__ const uint4 kZeroRow[768 / 8] = {};

__device__ __forceinline__ void unpack_bf16x8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Phase A, its own launch: Y = LN(dwconv7x7(x) + b_dw) as bf16, written to
// `y` tile by tile in the layout the block kernel's wgmmas read from shared
// memory (a_off; one 64-row tile is 128·C contiguous bytes, so the block
// kernel takes it with one bulk copy). Rows of the last tile past the last
// pixel are zeros. A team of lanes owns a run of R neighbours along F (R
// divides F, so a run never leaves its row); a lane owns GPL groups of 8
// channels. For each of the 7 rows of taps the team holds the row's 7
// weights and slides over the R + 6 inputs the run needs, each loaded and
// converted once and used for up to 7 taps. The eight teams of a CTA take
// the same columns of eight consecutive rows (b·T + t), so the 14 input
// rows they read can be shared through L1. Every load is issued: an input
// outside the map reads zeros.
template <int C, int R>
__global__ void __launch_bounds__(DwCfg<C>::THREADS)
block_dwln_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ dw_w,  // (49, C)
                  const float* __restrict__ dw_b,          // (C)
                  const float* __restrict__ ln_w,          // (C)
                  const float* __restrict__ ln_b,          // (C)
                  __nv_bfloat16* __restrict__ y,           // (n_out, C), tile order
                  int n_pix, int n_out, int T, int F, float eps) {
  using K = DwCfg<C>;
  const int team = threadIdx.x / K::TEAM;
  const int tl = threadIdx.x % K::TEAM;
  const int vr = blockIdx.y * K::TEAMS + team;  // b·T + t; past B·T only in the last tile
  const int p0 = vr * F + blockIdx.x * R;       // the run's first pixel
  const bool valid = p0 < n_pix;                // n_pix is a whole number of rows
  const int t = vr % T;
  const int f0 = p0 - vr * F;
  float acc[R][K::GPL][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < K::GPL; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < K::GPL; ++j) {
    const int grp = tl + K::TEAM * j;
    if (grp >= C / 8) continue;
    for (int di = 0; di < 7; ++di) {
      const bool row_in = valid && static_cast<unsigned>(t + di - 3) < static_cast<unsigned>(T);
      const __nv_bfloat16* xrow = x + static_cast<ptrdiff_t>(vr + di - 3) * F * C;
      const uint4* wrow = reinterpret_cast<const uint4*>(dw_w + di * 7 * C) + grp;
      float w[7][8];
#pragma unroll
      for (int dj = 0; dj < 7; ++dj) unpack_bf16x8(__ldg(wrow + dj * C / 8), w[dj]);
#pragma unroll
      for (int q = 0; q < R + 6; ++q) {
        const int ff = f0 - 3 + q;
        const bool in = row_in && static_cast<unsigned>(ff) < static_cast<unsigned>(F);
        const uint4* src = in ? reinterpret_cast<const uint4*>(xrow + ff * C) : kZeroRow;
        float v[8];
        unpack_bf16x8(__ldg(src + grp), v);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int dj = q - r;
          if (dj >= 0 && dj < 7) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][j][e] += v[e] * w[dj][e];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = p0 + r;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < K::GPL; ++j) {
      const int grp = tl + K::TEAM * j;
      if (grp < C / 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[r][j][e] = round_bf16(acc[r][j][e] + __ldg(dw_b + grp * 8 + e));
          sum += acc[r][j][e];
        }
      }
    }
    const float mean = team_sum<K::TEAM>(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < K::GPL; ++j) {
      if (tl + K::TEAM * j < C / 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = acc[r][j][e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(team_sum<K::TEAM>(sq) / C + eps);
    if (p >= n_out) continue;  // past the last tile: nothing to write
    __nv_bfloat16* yt = y + static_cast<size_t>(p / kRows) * kRows * C;
#pragma unroll
    for (int j = 0; j < K::GPL; ++j) {
      const int grp = tl + K::TEAM * j;
      if (grp < C / 8) {
        const float4* w4 = reinterpret_cast<const float4*>(ln_w + grp * 8);
        const float4* b4 = reinterpret_cast<const float4*>(ln_b + grp * 8);
        const float4 wa = __ldg(w4), wb = __ldg(w4 + 1), ba = __ldg(b4), bb = __ldg(b4 + 1);
        const float lw[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const float lb[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float y0 = valid ? (acc[r][j][e] - mean) * rstd * lw[e] + lb[e] : 0.0f;
          const float y1 = valid ? (acc[r][j][e + 1] - mean) * rstd * lw[e + 1] + lb[e + 1] : 0.0f;
          const __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
          packed[e / 2] = *reinterpret_cast<const uint32_t*>(&v);
        }
        *reinterpret_cast<uint4*>(yt + a_off(p % kRows, grp * 8)) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
}

// Phase A's launch: runs of 8 or 4 neighbours at one group of channels a
// lane, else 2, and single pixels for odd F; a CTA for each R columns of
// eight rows, over the rows that the 64-pixel tiles cover.
template <int C, int R>
cudaError_t launch_dwln_runs(const __nv_bfloat16* x, const __nv_bfloat16* dw_w,
                             const float* dw_b, const float* ln_w, const float* ln_b,
                             __nv_bfloat16* y, int n_pix, int T, int F, float eps,
                             cudaStream_t stream) {
  using K = DwCfg<C>;
  const int n_out = (n_pix + kRows - 1) / kRows * kRows;
  const int rows = (n_out + F - 1) / F;
  block_dwln_kernel<C, R><<<dim3(F / R, (rows + K::TEAMS - 1) / K::TEAMS), K::THREADS, 0, stream>>>(
      x, dw_w, dw_b, ln_w, ln_b, y, n_pix, n_out, T, F, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_dwln(const __nv_bfloat16* x, const __nv_bfloat16* dw_w, const float* dw_b,
                        const float* ln_w, const float* ln_b, __nv_bfloat16* y, int n_pix,
                        int T, int F, float eps, cudaStream_t stream) {
  if constexpr (DwCfg<C>::GPL == 1) {
    if (F % 8 == 0)
      return launch_dwln_runs<C, 8>(x, dw_w, dw_b, ln_w, ln_b, y, n_pix, T, F, eps, stream);
    if (F % 4 == 0)
      return launch_dwln_runs<C, 4>(x, dw_w, dw_b, ln_w, ln_b, y, n_pix, T, F, eps, stream);
  }
  if (F % 2 == 0)
    return launch_dwln_runs<C, 2>(x, dw_w, dw_b, ln_w, ln_b, y, n_pix, T, F, eps, stream);
  return launch_dwln_runs<C, 1>(x, dw_w, dw_b, ln_w, ln_b, y, n_pix, T, F, eps, stream);
}

template <int C>
__global__ void __maxnreg__(Cfg<C>::MAX_REGS)
convnext_block_kernel(const __nv_bfloat16* __restrict__ x,     // (n_pix, C)
                      const __nv_bfloat16* __restrict__ y,     // phase A's tiles
                      const __nv_bfloat16* __restrict__ wpack,  // pack_block_weights order
                      const float* __restrict__ b1,        // (4C)
                      const float* __restrict__ b2,        // (C)
                      const __nv_bfloat16* __restrict__ scale,  // (C)
                      __nv_bfloat16* __restrict__ out,     // (n_pix, C) when S == 1
                      float* __restrict__ partial,         // (S, n_pix, C) when S > 1
                      int n_pix) {
  using K = Cfg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + K::G_OFF);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t ring = sbase + K::RING_OFF;
  const uint32_t full = sbase + K::BAR_OFF;        // + 8 · slot
  const uint32_t empty = full + 8 * K::RING;         // + 8 · slot
  const uint32_t y_full = empty + 8 * K::RING;

  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int ch0 = split * K::NCH / n_split;
  const int ch1 = (split + 1) * K::NCH / n_split;
  const int n_stages = (ch1 - ch0) * 2 * K::P;
  const int pix0 = blockIdx.x * kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, K::CONSUMERS / 32);
    }
    mbar_init(y_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage i of this CTA's weights into ring slot i % K::RING, once every
  // consumer warp has released the slot's previous stage
  const unsigned char* src = reinterpret_cast<const unsigned char*>(wpack) +
                             static_cast<size_t>(ch0) * 2 * K::P * K::STAGE_BYTES;
  auto issue = [&](int i) {
    const int s = i % K::RING;
    mbar_wait(empty + 8 * s, ((i / K::RING) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, K::STAGE_BYTES);
    bulk_copy(ring + s * K::STAGE_BYTES, src + static_cast<size_t>(i) * K::STAGE_BYTES,
              K::STAGE_BYTES, full + 8 * s);
  };
  // the tile's Y, 128·C contiguous bytes, then the weights
  const uint32_t ys_addr = sbase + K::Y_OFF;
  auto issue_y = [&]() {
    mbar_expect_tx(y_full, K::Y_BYTES);
    bulk_copy(ys_addr, y + static_cast<size_t>(pix0) * C, K::Y_BYTES, y_full);
  };
  if (K::PRODUCER_WARP && threadIdx.x >= K::CONSUMERS) {  // ---- producer warp
    if (threadIdx.x == K::CONSUMERS) {
      issue_y();
      for (int i = 0; i < n_stages; ++i) issue(i);
    }
    return;
  }
  if (!K::PRODUCER_WARP && threadIdx.x == 0) {  // Y and the first K::RING stages
    issue_y();
    for (int i = 0; i < n_stages && i < K::RING; ++i) issue(i);
  }

  // ---- consumers
  mbar_wait(y_full, 0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int wr = warp % 4;        // rows 16·wr .. 16·wr + 15 of the tile
  const int gq = lane / 4;        // accumulator row
  const int q = lane % 4;         // accumulator column pair
  const uint32_t gs_addr = sbase + K::G_OFF;
  // a k16 step of an A tile (64 rows) is 2 KB; an n-group of a B stage 256 B
  constexpr uint32_t kA16 = kRows * 16 * 2;

  float z[K::N2 / 8][4];
#pragma unroll
  for (int j = 0; j < K::N2 / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[j][e] = 0.0f;

  // each warp releases a ring stage once its warpgroup's wgmmas on it are
  // done; without a producer warp, thread 0 then refills the slot
  auto release = [&](int stage_it) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty + 8 * (stage_it % K::RING));
      if (!K::PRODUCER_WARP && threadIdx.x == 0 && stage_it + K::RING < n_stages)
        issue(stage_it + K::RING);
    }
    __syncwarp();
  };

  int it = 0;  // ring stage counter
  for (int ch = ch0; ch < ch1; ++ch) {
    // Hc[:, wg's N1 columns] = Y · W1[:, chunk]; a W1 stage is
    // [KB1][64/8 n-groups][2][8][8]
    float h[K::N1 / 8][4];
#pragma unroll
    for (int j = 0; j < K::N1 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] = 0.0f;
    for (int p = 0; p < K::P; ++p, ++it) {
      const int s = it % K::RING;
      mbar_wait(full + 8 * s, (it / K::RING) & 1);
      const uint32_t stage = ring + s * K::STAGE_BYTES + wg * (K::N1 / 8) * 256;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K::KB1; ++kk)
        wgmma_bf16<K::N1>(h, smem_desc(ys_addr + (p * K::KB1 + kk) * kA16),
                          smem_desc(stage + kk * (kHC / 8) * 256));
      wgmma_commit();
      if (p > 0) {
        wgmma_wait<1>();
        release(it - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(h);
    release(it - 1);
    // + b1, bf16, GELU, bf16 -> G (double-buffered by chunk parity)
    __nv_bfloat16* g = gs + (ch & 1) * kRows * kHC;
#pragma unroll
    for (int j = 0; j < K::N1 / 8; ++j) {
      const int col = wg * K::N1 + j * 8 + 2 * q;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + ch * kHC + col));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 16 * wr + gq + 8 * half;
        const float h0 = round_bf16(h[j][2 * half] + bias.x);
        const float h1 = round_bf16(h[j][2 * half + 1] + bias.y);
        *reinterpret_cast<__nv_bfloat162*>(g + a_off(m, col)) =
            __floats2bfloat162_rn(gelu_erf(h0), gelu_erf(h1));
      }
    }
    fence_proxy_async();
    consumer_sync(K::CONSUMERS);
    // Z[:, wg's N2 columns] += G · W2[chunk, :]; a W2 stage is
    // [KB2][C/8 n-groups][2][8][8]
    const uint32_t g_addr = gs_addr + (ch & 1) * kRows * kHC * 2;
    for (int p = 0; p < K::P; ++p, ++it) {
      const int s = it % K::RING;
      mbar_wait(full + 8 * s, (it / K::RING) & 1);
      const uint32_t stage = ring + s * K::STAGE_BYTES + wg * (K::N2 / 8) * 256;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K::KB2; ++kk)
        wgmma_bf16<K::N2>(z, smem_desc(g_addr + (p * K::KB2 + kk) * kA16),
                          smem_desc(stage + kk * (C / 8) * 256));
      wgmma_commit();
      if (p > 0) {
        wgmma_wait<1>();
        release(it - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(z);
    release(it - 1);
  }

  // ---- epilogue
  if (n_split > 1) {  // f32 partials; block_reduce_kernel applies the rest
#pragma unroll
    for (int j = 0; j < K::N2 / 8; ++j) {
      const int c = wg * K::N2 + j * 8 + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pix = pix0 + 16 * wr + gq + 8 * half;
        if (pix < n_pix)
          *reinterpret_cast<float2*>(partial + (static_cast<size_t>(split) * n_pix + pix) * C + c) =
              make_float2(z[j][2 * half], z[j][2 * half + 1]);
      }
    }
    return;
  }
  // t = round(round(z + b2) · scale) as bf16 into shared memory, over Y and
  // G, which no wgmma reads any more (rows 2·C + 16 bytes apart, so a
  // warp's stores fall on distinct banks); then out = x + t, 16 bytes a
  // thread, each row of the tile contiguous in x and out
  constexpr int kTRow = 2 * C + 16;
  unsigned char* ts = smem + K::Y_OFF;
  consumer_sync(K::CONSUMERS);
#pragma unroll
  for (int j = 0; j < K::N2 / 8; ++j) {
    const int c = wg * K::N2 + j * 8 + 2 * q;
    const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + c));
    const float2 sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(scale + c));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * wr + gq + 8 * half;
      *reinterpret_cast<__nv_bfloat162*>(ts + m * kTRow + c * 2) = __floats2bfloat162_rn(
          round_bf16(z[j][2 * half] + bias.x) * sc.x, round_bf16(z[j][2 * half + 1] + bias.y) * sc.y);
    }
  }
  consumer_sync(K::CONSUMERS);
  for (int k = threadIdx.x; k < kRows * C / 8; k += K::CONSUMERS) {
    const int m = k / (C / 8);
    const int c8 = k % (C / 8);
    const size_t pix = static_cast<size_t>(pix0) + m;
    if (pix >= static_cast<size_t>(n_pix)) break;  // k grows with m
    const uint4 tv = *reinterpret_cast<const uint4*>(ts + m * kTRow + c8 * 16);
    const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + pix * C) + c8);
    float tf[8], xf[8];
    unpack_bf16x8(tv, tf);
    unpack_bf16x8(xv, xf);
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(xf[e] + tf[e], xf[e + 1] + tf[e + 1]);
      packed[e / 2] = *reinterpret_cast<const uint32_t*>(&v);
    }
    reinterpret_cast<uint4*>(out + pix * C)[c8] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// The S partial sums of a split block, added in split order, then the
// epilogue: out = x + round(round(z + b2) * scale). Four channels a thread.
__global__ void block_reduce_kernel(const __nv_bfloat16* __restrict__ x,
                                    const float* __restrict__ partial,
                                    const float* __restrict__ b2,
                                    const __nv_bfloat16* __restrict__ scale,
                                    __nv_bfloat16* __restrict__ out, int n_pix, int C,
                                    int n_split) {
  const size_t n4 = static_cast<size_t>(n_pix) * C / 4;
  const size_t stride = n4;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 z = __ldg(reinterpret_cast<const float4*>(partial) + i);
    for (int s = 1; s < n_split; ++s) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(partial) + s * stride + i);
      z.x += v.x;
      z.y += v.y;
      z.z += v.z;
      z.w += v.w;
    }
    const int c = static_cast<int>((i * 4) % C);
    const float4 bias = __ldg(reinterpret_cast<const float4*>(b2 + c));
    const uint2 sr = __ldg(reinterpret_cast<const uint2*>(scale + c));
    const float2 s01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sr.x));
    const float2 s23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sr.y));
    const float4 sc = make_float4(s01.x, s01.y, s23.x, s23.y);
    const uint2 xr = __ldg(reinterpret_cast<const uint2*>(x) + i);
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
    uint2 o;
    *reinterpret_cast<__nv_bfloat162*>(&o.x) = __floats2bfloat162_rn(
        x01.x + round_bf16(round_bf16(z.x + bias.x) * sc.x),
        x01.y + round_bf16(round_bf16(z.y + bias.y) * sc.y));
    *reinterpret_cast<__nv_bfloat162*>(&o.y) = __floats2bfloat162_rn(
        x23.x + round_bf16(round_bf16(z.z + bias.z) * sc.z),
        x23.y + round_bf16(round_bf16(z.w + bias.w) * sc.w));
    reinterpret_cast<uint2*>(out)[i] = o;
  }
}

// The per-call preparation, in one launch: W1 and W2 (f32) cast to bf16
// and laid out in the ring's order (pack_block_weights is its plain
// version), then the depthwise weights and the layer scale cast to bf16
// behind them. One thread writes 8 values (16 bytes).
__global__ void block_pack_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                                  const float* __restrict__ dw_w, const float* __restrict__ scale,
                                  __nv_bfloat16* __restrict__ work, int C) {
  const int H = 4 * C;
  const int n_w = C * H / 4;  // 8-value rows of the packed W1 and W2
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v[8];
  if (i < n_w) {
    const int ch = i / (16 * C);  // 64-wide hidden chunk: 16·C rows of 8
    const int idx = i % (8 * C);  // row within the chunk's W1 or W2 part
    const int nr = idx % 8;
    const int kh = (idx / 8) % 2;
    if (i % (16 * C) < 8 * C) {  // W1[:, chunk]: K = C, N = 64
      const int ng = (idx / 16) % 8;
      const int k0 = (idx / 128) * 16 + kh * 8;
      const int n = ch * kHC + ng * 8 + nr;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __ldg(w1 + static_cast<size_t>(k0 + e) * H + n);
    } else {  // W2[chunk, :]: K = 64, N = C
      const int ng = (idx / 16) % (C / 8);
      const int k0 = ch * kHC + (idx / (2 * C)) * 16 + kh * 8;
      const int n = ng * 8 + nr;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __ldg(w2 + static_cast<size_t>(k0 + e) * C + n);
    }
  } else if (i < n_w + 50 * C / 8) {  // dw_w (49·C) then scale (C)
    const int j = (i - n_w) * 8;
    const float* src = j < 49 * C ? dw_w + j : scale + (j - 49 * C);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __ldg(src + e);
  } else {
    return;
  }
  uint32_t packed[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[e], v[e + 1]);
    packed[e / 2] = *reinterpret_cast<const uint32_t*>(&b);
  }
  reinterpret_cast<uint4*>(work)[i] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

template <int C>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                   const void* ln_b, const void* w1, const void* w2, const void* b1,
                   const void* b2, const void* scale, void* work, void* y, void* out,
                   void* partial, int n_pix, int T, int F, int n_split, float eps,
                   cudaStream_t stream) {
  using K = Cfg<C>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        convnext_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(K::SMEM));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  // work: the packed W1 and W2 (2·C·H), then dw_w (49·C) and scale (C), bf16
  __nv_bfloat16* wpack = static_cast<__nv_bfloat16*>(work);
  const __nv_bfloat16* dwb = wpack + 2 * C * K::H;
  const __nv_bfloat16* scaleb = dwb + 49 * C;
  const int n8 = C * K::H / 4 + 50 * C / 8;
  block_pack_kernel<<<(n8 + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(dw_w), static_cast<const float*>(scale), wpack, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  err = launch_dwln<C>(xb, dwb, static_cast<const float*>(dw_b), static_cast<const float*>(ln_w),
                       static_cast<const float*>(ln_b), yb, n_pix, T, F, eps, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_pix + kRows - 1) / kRows, n_split);
  convnext_block_kernel<C><<<grid, K::THREADS, K::SMEM, stream>>>(
      xb, yb, wpack, static_cast<const float*>(b1), static_cast<const float*>(b2), scaleb,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial), n_pix);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int n4 = n_pix * C / 4;
  const int blocks = (n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024;
  block_reduce_kernel<<<blocks, 256, 0, stream>>>(
      xb, static_cast<const float*>(partial), static_cast<const float*>(b2), scaleb,
      static_cast<__nv_bfloat16*>(out), n_pix, C, n_split);
  return cudaGetLastError();
}

}  // namespace

// C entry point: returns the cudaError_t of the launches (0 on success).
// dw_w, w1, w2 and scale are the f32 parameters as the model holds them;
// `work` is a bf16 buffer of 2·C·H + 50·C for their prepared copies; `y`
// a bf16 (ceil(B·T·F / 64) · 64, C) buffer for phase A's tiles; with
// n_split > 1, `partial` is an f32 (n_split, B·T·F, C) scratch buffer.
extern "C" int conette_convnext_block(const void* x, const void* dw_w, const void* dw_b,
                                      const void* ln_w, const void* ln_b, const void* w1,
                                      const void* w2, const void* b1, const void* b2,
                                      const void* scale, void* work, void* y, void* out,
                                      void* partial, int B, int T, int F, int C, int n_split,
                                      float eps, void* stream) {
  const int n_pix = B * T * F;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > 4 * C / kHC || (n_split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 96:
      return launch<96>(x, dw_w, dw_b, ln_w, ln_b, w1, w2, b1, b2, scale, work, y, out, partial,
                        n_pix, T, F, n_split, eps, s);
    case 192:
      return launch<192>(x, dw_w, dw_b, ln_w, ln_b, w1, w2, b1, b2, scale, work, y, out,
                         partial, n_pix, T, F, n_split, eps, s);
    case 384:
      return launch<384>(x, dw_w, dw_b, ln_w, ln_b, w1, w2, b1, b2, scale, work, y, out,
                         partial, n_pix, T, F, n_split, eps, s);
    case 768:
      return launch<768>(x, dw_w, dw_b, ln_w, ln_b, w1, w2, b1, b2, scale, work, y, out,
                         partial, n_pix, T, F, n_split, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
