// One whole ConvNeXt block in one pass over device memory, bf16 in and out:
//
//   out = x + scale * (W2 · GELU(W1 · LN(dwconv7x7(x) + b_dw) + b1) + b2)
//
// Replaces the TPU kernel conette_tpu/ops/pallas/convnext_block.py:
// fused_convnext_block_padded (body _fused_block_kernel). It ports the math,
// not the Mosaic tiling: no (8, 128) stage padding, no VMEM plans; the kernel
// takes contiguous NHWC (B, T, F, C) bf16 at its real extents.
//
// What bounds it on the H100: per pixel the block does 2·C·2H + 98·C
// operations (H = 4C) against 4·C bytes of activations, so the stages with
// C = 96..384 are bound by the tensor cores at batch >= 8; the C = 768 stage
// has few pixels (31 x 7 a clip) and reads 9.4 MB of bf16 weights per
// launch, so at small batch the weight and activation bytes bound it.
//
// What the design does about it: the 4C-wide hidden layer never leaves the
// SM. A thread block owns kM = 32 consecutive output pixels:
//   phase A  the 49-tap depthwise stencil in f32 (neighbours read from
//            global memory / L1 / L2, zero outside [0, T) x [0, F)), + b_dw,
//            LayerNorm with f32 statistics by warp reductions over C; the
//            normalised rows Y[kM][C] go to shared memory as bf16;
//   phase B  the MLP on the tensor cores (WMMA 16x16x16 bf16, f32
//            accumulation) over H in chunks of kHC = 64: Hc = Y · W1[:, chunk]
//            gets b1 and the exact-erf GELU in f32, is rounded to bf16 in
//            shared memory and multiplied into the (kM, C) f32 accumulators
//            that live in registers for the whole block;
//   epilogue x + scale · (z + b2), cast to bf16.
// The products are this kernel's own; no library GEMM is called. The values
// are rounded to bf16 at the same points as the plain PyTorch version
// (conette_torch/kernels/convnext_block.py::convnext_block_reference), so
// the two differ only by f32 summation order. Weights are read straight
// from global memory (L2-resident across blocks); staging them through
// shared memory with TMA and wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

using namespace nvcuda;

namespace {

constexpr int kM = 32;          // output pixels per thread block
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHC = 64;         // hidden-layer chunk
constexpr int kPad = 8;         // bf16 row padding: rows stay 32-byte aligned

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C>
struct BlockShape {
  static constexpr int H = 4 * C;
  static constexpr int CPL = C / 32;          // channels per lane, phase A
  static constexpr int LDY = C + kPad;        // Y row stride (bf16)
  static constexpr int LDH = kHC + kPad;      // GELU(Hc) row stride (bf16)
  static constexpr int LDF = kHC + 8;         // Hc f32 staging row stride
  static constexpr int NT = (kM / 16) * (C / 16);   // output 16x16 tiles
  static constexpr int FR = (NT + kWarps - 1) / kWarps;
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * kM * LDY +
                                  sizeof(float) * kM * LDF +
                                  sizeof(__nv_bfloat16) * kM * LDH +
                                  sizeof(float) * kWarps * 256;
};

template <int C>
__global__ void __launch_bounds__(kThreads)
convnext_block_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ dw_w,    // (49, C)
                      const float* __restrict__ dw_b,    // (C)
                      const float* __restrict__ ln_w,    // (C)
                      const float* __restrict__ ln_b,    // (C)
                      const __nv_bfloat16* __restrict__ w1,  // (C, 4C)
                      const float* __restrict__ b1,      // (4C)
                      const __nv_bfloat16* __restrict__ w2,  // (4C, C)
                      const float* __restrict__ b2,      // (C)
                      const float* __restrict__ scale,   // (C)
                      __nv_bfloat16* __restrict__ out,
                      int n_pix, int T, int F, float eps) {
  using S = BlockShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  float* hf = reinterpret_cast<float*>(ys + kM * S::LDY);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(hf + kM * S::LDF);
  float* scratch = reinterpret_cast<float*>(hs + kM * S::LDH);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pix0 = blockIdx.x * kM;
  const int TF = T * F;

  // ---- phase A: depthwise 7x7 + b_dw + LayerNorm -> Y (bf16, shared)
  for (int pp = 0; pp < kM / kWarps; ++pp) {
    const int p = warp * (kM / kWarps) + pp;
    const int g = pix0 + p;
    __nv_bfloat16* yrow = ys + p * S::LDY;
    if (g >= n_pix) {
#pragma unroll
      for (int k = 0; k < S::CPL; ++k) yrow[lane + 32 * k] = __float2bfloat16(0.0f);
      continue;
    }
    const int b = g / TF;
    const int r = g - b * TF;
    const int t = r / F;
    const int f = r - t * F;
    float acc[S::CPL];
#pragma unroll
    for (int k = 0; k < S::CPL; ++k) acc[k] = 0.0f;
    for (int i = 0; i < 7; ++i) {
      const int tt = t + i - 3;
      if (tt < 0 || tt >= T) continue;
      for (int j = 0; j < 7; ++j) {
        const int ff = f + j - 3;
        if (ff < 0 || ff >= F) continue;
        const __nv_bfloat16* src = x + (static_cast<size_t>(b * T + tt) * F + ff) * C;
        const float* wt = dw_w + (i * 7 + j) * C;
#pragma unroll
        for (int k = 0; k < S::CPL; ++k) {
          const int c = lane + 32 * k;
          acc[k] += __bfloat162float(src[c]) * __ldg(wt + c);
        }
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < S::CPL; ++k) {
      acc[k] = round_bf16(acc[k] + __ldg(dw_b + lane + 32 * k));
      sum += acc[k];
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < S::CPL; ++k) {
      const float d = acc[k] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int k = 0; k < S::CPL; ++k) {
      const int c = lane + 32 * k;
      yrow[c] = __float2bfloat16((acc[k] - mean) * rstd * __ldg(ln_w + c) + __ldg(ln_b + c));
    }
  }
  __syncthreads();

  // ---- phase B: MLP over H in chunks; Z accumulates in registers
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> zacc[S::FR];
#pragma unroll
  for (int fi = 0; fi < S::FR; ++fi) wmma::fill_fragment(zacc[fi], 0.0f);

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;

  for (int h0 = 0; h0 < S::H; h0 += kHC) {
    {  // Hc = Y · W1[:, h0:h0+kHC]: (kM/16) x (kHC/16) = 8 tiles, one a warp
      const int rt = warp / (kHC / 16);
      const int ct = warp % (kHC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
      wmma::fill_fragment(hacc, 0.0f);
      for (int k0 = 0; k0 < C; k0 += 16) {
        wmma::load_matrix_sync(a, ys + rt * 16 * S::LDY + k0, S::LDY);
        wmma::load_matrix_sync(bm, w1 + static_cast<size_t>(k0) * S::H + h0 + ct * 16, S::H);
        wmma::mma_sync(hacc, a, bm, hacc);
      }
      wmma::store_matrix_sync(hf + rt * 16 * S::LDF + ct * 16, hacc, S::LDF,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kM * kHC; e += kThreads) {
      const int p = e / kHC;
      const int j = e % kHC;
      const float h = round_bf16(hf[p * S::LDF + j] + __ldg(b1 + h0 + j));
      hs[p * S::LDH + j] = __float2bfloat16(gelu_erf(h));
    }
    __syncthreads();
#pragma unroll
    for (int fi = 0; fi < S::FR; ++fi) {  // Z += GELU(Hc) · W2[h0:h0+kHC, :]
      const int tile = warp + fi * kWarps;
      if (tile < S::NT) {
        const int rt = tile % (kM / 16);
        const int ct = tile / (kM / 16);
#pragma unroll
        for (int kk = 0; kk < kHC; kk += 16) {
          wmma::load_matrix_sync(a, hs + rt * 16 * S::LDH + kk, S::LDH);
          wmma::load_matrix_sync(bm, w2 + static_cast<size_t>(h0 + kk) * C + ct * 16, C);
          wmma::mma_sync(zacc[fi], a, bm, zacc[fi]);
        }
      }
    }
    // hf is rewritten only after the next chunk's first barrier, and hs
    // only after its second: no third barrier is needed here.
  }

  // ---- epilogue: out = x + round(round(z + b2) * scale), per 16x16 tile
  float* ws = scratch + warp * 256;
#pragma unroll
  for (int fi = 0; fi < S::FR; ++fi) {
    const int tile = warp + fi * kWarps;
    if (tile < S::NT) {
      const int rt = tile % (kM / 16);
      const int ct = tile / (kM / 16);
      wmma::store_matrix_sync(ws, zacc[fi], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int g = pix0 + rt * 16 + e / 16;
        const int c = ct * 16 + e % 16;
        if (g < n_pix) {
          const size_t o = static_cast<size_t>(g) * C + c;
          const float z = round_bf16(ws[e] + __ldg(b2 + c));
          const float y = round_bf16(z * __ldg(scale + c));
          out[o] = __float2bfloat16(__bfloat162float(x[o]) + y);
        }
      }
      __syncwarp();
    }
  }
}

template <int C>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                   const void* ln_b, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* scale, void* out, int n_pix, int T, int F,
                   float eps, cudaStream_t stream) {
  const size_t smem = BlockShape<C>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      convnext_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (n_pix + kM - 1) / kM;
  convnext_block_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dw_w),
      static_cast<const float*>(dw_b), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), n_pix, T, F, eps);
  return cudaGetLastError();
}

}  // namespace

// C entry point: returns the cudaError_t of the launch (0 on success).
extern "C" int conette_convnext_block(const void* x, const void* dw_w, const void* dw_b,
                                      const void* ln_w, const void* ln_b, const void* w1,
                                      const void* b1, const void* w2, const void* b2,
                                      const void* scale, void* out, int B, int T, int F,
                                      int C, float eps, void* stream) {
  const int n_pix = B * T * F;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96:
      return launch<96>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, scale, out, n_pix, T, F, eps, s);
    case 192:
      return launch<192>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, scale, out, n_pix, T, F, eps, s);
    case 384:
      return launch<384>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, scale, out, n_pix, T, F, eps, s);
    case 768:
      return launch<768>(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, scale, out, n_pix, T, F, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
