// The downsample seam between two ConvNeXt stages, bf16 in and out:
//
//   out[b, t2, f2, :] = bias + sum_{i,j in {0,1}} LN(x[b, 2t2+i, 2f2+j, :]) · W[i, j]
//
// i.e. LayerNorm over C (f32 statistics) followed by Conv2d(k=2, s=2) from
// C to 2C. Replaces the TPU kernel conette_tpu/ops/pallas/downsample.py:
// fused_downsample_padded (body _fused_downsample_kernel), without its
// stage padding or stride-2 restructuring: the input is contiguous NHWC
// (B, T, F, C) at its real extents, an odd T floors (the last row is
// dropped), F must be even.
//
// What bounds it on the H100: it is a GEMM with K = 4C and N = 2C whose A
// rows are gathered and normalised on the fly, about 0.5 GFLOP a clip for
// every seam. At small batch the activation bytes (in + out) and the
// 4C x 2C weight bound it rather than the tensor cores.
//
// What the design does about it: one pass over the input. A thread block
// owns kM = 32 output pixels and kN = 64 output channels. It first computes
// the LayerNorm of its 4·kM input pixels (one warp a pixel, f32 statistics by
// warp reductions) and stores the normalised, bf16-rounded A rows
// [kM][4C] in shared memory; then it multiplies A by W[:, n0:n0+kN] on the
// tensor cores (WMMA 16x16x16 bf16, f32 accumulation), adds the bias and
// writes bf16. The normalised input never goes back to device memory. The
// rounding points are those of the plain PyTorch version
// (conette_torch/kernels/downsample.py::downsample_reference).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

using namespace nvcuda;

namespace {

constexpr int kM = 32;          // output pixels per thread block
constexpr int kN = 64;          // output channels per thread block
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C>
struct SeamShape {
  static constexpr int K = 4 * C;
  static constexpr int N = 2 * C;
  static constexpr int CPL = C / 32;
  static constexpr int LDA = K + 8;  // bf16 row stride, rows stay 32-byte aligned
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * kM * LDA + sizeof(float) * kWarps * 256;
};

template <int C>
__global__ void __launch_bounds__(kThreads)
downsample_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ ln_w,       // (C)
                  const float* __restrict__ ln_b,       // (C)
                  const __nv_bfloat16* __restrict__ w,  // (2, 2, C, 2C) = (4C, 2C)
                  const float* __restrict__ bias,       // (2C)
                  __nv_bfloat16* __restrict__ out,      // (B, T/2, F/2, 2C)
                  int n_out, int T, int F, float eps) {
  using S = SeamShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  float* scratch = reinterpret_cast<float*>(as + kM * S::LDA);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pix0 = blockIdx.x * kM;
  const int n0 = blockIdx.y * kN;
  const int T2 = T / 2;
  const int F2 = F / 2;

  // ---- phase A: LayerNorm of the 4·kM input pixels -> A (bf16, shared)
  for (int s = warp; s < 4 * kM; s += kWarps) {
    const int p = s / 4;
    const int q = s % 4;  // patch position i * 2 + j
    const int g = pix0 + p;
    __nv_bfloat16* dst = as + p * S::LDA + q * C;
    if (g >= n_out) {
#pragma unroll
      for (int k = 0; k < S::CPL; ++k) dst[lane + 32 * k] = __float2bfloat16(0.0f);
      continue;
    }
    const int b = g / (T2 * F2);
    const int r = g - b * (T2 * F2);
    const int t2 = r / F2;
    const int f2 = r - t2 * F2;
    const __nv_bfloat16* src =
        x + (static_cast<size_t>(b * T + 2 * t2 + q / 2) * F + 2 * f2 + q % 2) * C;
    float v[S::CPL];
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < S::CPL; ++k) {
      v[k] = __bfloat162float(src[lane + 32 * k]);
      sum += v[k];
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < S::CPL; ++k) {
      const float d = v[k] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int k = 0; k < S::CPL; ++k) {
      const int c = lane + 32 * k;
      dst[c] = __float2bfloat16((v[k] - mean) * rstd * __ldg(ln_w + c) + __ldg(ln_b + c));
    }
  }
  __syncthreads();

  // ---- phase B: (kM x 4C) · (4C x kN): 2 x 4 output tiles, one a warp
  const int rt = warp / (kN / 16);
  const int ct = warp % (kN / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
  wmma::fill_fragment(acc, 0.0f);
  for (int k0 = 0; k0 < S::K; k0 += 16) {
    wmma::load_matrix_sync(a, as + rt * 16 * S::LDA + k0, S::LDA);
    wmma::load_matrix_sync(bm, w + static_cast<size_t>(k0) * S::N + n0 + ct * 16, S::N);
    wmma::mma_sync(acc, a, bm, acc);
  }

  // ---- epilogue: + bias, bf16
  float* ws = scratch + warp * 256;
  wmma::store_matrix_sync(ws, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int g = pix0 + rt * 16 + e / 16;
    const int n = n0 + ct * 16 + e % 16;
    if (g < n_out) {
      out[static_cast<size_t>(g) * S::N + n] = __float2bfloat16(ws[e] + __ldg(bias + n));
    }
  }
}

template <int C>
cudaError_t launch(const void* x, const void* ln_w, const void* ln_b, const void* w,
                   const void* bias, void* out, int n_out, int T, int F, float eps,
                   cudaStream_t stream) {
  const size_t smem = SeamShape<C>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      downsample_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_out + kM - 1) / kM, SeamShape<C>::N / kN);
  downsample_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), n_out, T, F, eps);
  return cudaGetLastError();
}

}  // namespace

// C entry point: returns the cudaError_t of the launch (0 on success).
extern "C" int conette_downsample(const void* x, const void* ln_w, const void* ln_b,
                                  const void* w, const void* bias, void* out, int B, int T,
                                  int F, int C, float eps, void* stream) {
  const int n_out = B * (T / 2) * (F / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96:
      return launch<96>(x, ln_w, ln_b, w, bias, out, n_out, T, F, eps, s);
    case 192:
      return launch<192>(x, ln_w, ln_b, w, bias, out, n_out, T, F, eps, s);
    case 384:
      return launch<384>(x, ln_w, ln_b, w, bias, out, n_out, T, F, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The message of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* conette_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
