// Fused RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   rmsnorm  <- src/repro/kernels/rmsnorm/rmsnorm.py _rmsnorm_kernel (:19),
//               launched by rmsnorm_call (:26, pl.pallas_call at :31)
//
//   out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale[:]
//
// with the reduction in float and the result cast back to x's dtype.
//
// Bound: a handful of flops per element against one read of x and one
// write of out (scale is d elements, read once per row from L1/L2), so it
// is bound by memory traffic: 2 * rows * d * sizeof(x) bytes. At the LM
// serve path's shapes on an H100 SXM (3.35 TB/s), bf16: the d_model norm of
// a 4 x 1024 prefill (4096 x 2048) moves 33.6 MB, 10.0 us; qwen3's q-norm
// (65536 x 128) the same; one decode step's d_model norm (4 x 2048) 33 KB,
// far below a launch's own cost.
//
// Design against that bound: one warp per row, several rows per block.
// Each lane reads every 32nd element of its row (neighbouring lanes on
// neighbouring addresses, so each warp load is coalesced), keeps the
// values it read in shared memory, sums their squares in float, and the
// warp reduces the sum with shuffles — no block-wide barrier. The lane
// then writes its own elements from shared memory, so x is read from
// device memory once. Any d (up to what one warp's row takes in shared
// memory) and any row count are taken: the rows of the last block past
// the end return at once, where the TPU kernel asserted rows % block == 0.
// Shared memory above 48 KB is requested with the dynamic attribute.
// Nothing is allocated here; the launch goes on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 2 };

constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename TX, typename TS>
__global__ void rmsnorm_kernel(int64_t rows, int d, const TX* __restrict__ x,
                               const TS* __restrict__ scale, float eps,
                               TX* __restrict__ out) {
  extern __shared__ float buf[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  float* mine = buf + size_t(warp) * d;
  const TX* xr = x + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = ld(xr, i);
    mine[i] = v;
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / float(d) + eps);
  TX* orow = out + row * d;
  for (int i = lane; i < d; i += 32) {
    const float y = mine[i] * r;
    st(orow, i, y * ld(scale, i));
  }
}

template <typename TX, typename TS>
int launch(int64_t rows, int d, const void* x, const void* scale, float eps,
           void* out, cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return int(cudaErrorInvalidValue);
  const size_t row_bytes = size_t(d) * sizeof(float);
  if (row_bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  int warps = int(kMaxSmem / row_bytes);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const size_t smem = row_bytes * warps;
  if (smem > kDefaultSmem) {
    static size_t granted = kDefaultSmem;  // per (TX, TS) instantiation
    if (smem > granted) {
      cudaError_t e = cudaFuncSetAttribute(
          rmsnorm_kernel<TX, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          int(kMaxSmem));
      if (e != cudaSuccess) return int(e);
      granted = kMaxSmem;
    }
  }
  const int64_t blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  rmsnorm_kernel<TX, TS><<<unsigned(blocks), warps * 32, smem, stream>>>(
      rows, d, static_cast<const TX*>(x), static_cast<const TS*>(scale), eps,
      static_cast<TX*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: [rows, d] contiguous of x_dtype; scale: [d] of scale_dtype.
// dtype codes: 0 float32, 2 bfloat16.
int rmsnorm(int x_dtype, int scale_dtype, int64_t rows, int d, const void* x,
            const void* scale, float eps, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && scale_dtype == kFloat32)
    return launch<float, float>(rows, d, x, scale, eps, out, s);
  if (x_dtype == kFloat32 && scale_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(rows, d, x, scale, eps, out, s);
  if (x_dtype == kBFloat16 && scale_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(rows, d, x, scale, eps, out, s);
  if (x_dtype == kBFloat16 && scale_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(rows, d, x, scale, eps, out,
                                                s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
