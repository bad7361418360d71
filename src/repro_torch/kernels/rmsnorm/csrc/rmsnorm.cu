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
// Design against that bound (rmsnorm_vec_kernel): every load and store
// moves 16 bytes a lane (8 bf16 or 4 f32), and the row stays in registers
// between its read and its write, so x is read from device memory once
// with no shared memory. A group of L lanes owns a row: L = 8 for rows of
// at most 8 vectors, 16 for at most 16 (qwen3's q/k-norm, d = 128 in
// bf16), else a whole warp; each lane holds VPL vectors (lane, lane + L,
// ...), VPL instantiated for every width the configs use (up to 32
// vectors a lane: d = 8192 in bf16, 4096 in f32), the ragged last lanes
// masked. The lanes sum their squares in float and the group reduces the
// sum with shuffles; scale is read as vectors too (from L1/L2). 256
// threads a block. Widths the vectors cannot take keep the scalar kernel
// (rmsnorm_kernel below, one warp per row staged in shared memory): d not
// a multiple of 8 (bf16) or 4 (f32), d above 8192 (bf16) or 4096 (f32),
// or x, scale or out not 16-byte aligned; the launcher picks by d and
// the pointers.
//
// The scalar kernel: one warp per row, several rows per block. Each lane
// reads every 32nd element of its row (neighbouring lanes on
// neighbouring addresses, so each warp load is coalesced), keeps the
// values it read in shared memory, sums their squares in float, and the
// warp reduces the sum with shuffles. The lane then writes its own
// elements from shared memory, so x is read from device memory once.
//
// Any d and any row count are taken: the rows of the last block past the
// end do no loads or stores, where the TPU kernel asserted
// rows % block == 0. Shared memory above 48 KB is requested with the
// dynamic attribute. Nothing is allocated here; the launch goes on the
// caller's stream and returns cudaGetLastError().

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

// ---- 16-byte vectors, the row in registers ----

constexpr int kVecThreads = 256;

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f);
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* f) {
  const float* v = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = v[i];
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// E elements of scale from p (16-byte aligned for f32 and E = 8, 8-byte
// aligned for bf16 and E = 4), as float
template <typename TS, int E>
__device__ __forceinline__ void load_scale(const TS* p, float* f) {
  constexpr int kPer = 16 / sizeof(TS);  // elements per 16-byte load
  if constexpr (E >= kPer) {
#pragma unroll
    for (int i = 0; i < E / kPer; ++i) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
      unpack<TS>(raw, f + i * kPer);
    }
  } else {  // 4 bf16: one 8-byte load
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}

// L lanes per row, VPL 16-byte vectors per lane
template <typename TX, typename TS, int L, int VPL>
__global__ void __launch_bounds__(kVecThreads)
    rmsnorm_vec_kernel(int64_t rows, int d, const TX* __restrict__ x,
                       const TS* __restrict__ scale, float eps,
                       TX* __restrict__ out) {
  constexpr int E = 16 / sizeof(TX);  // elements per vector
  const int lane = threadIdx.x % L;
  const int64_t row =
      int64_t(blockIdx.x) * (kVecThreads / L) + threadIdx.x / L;
  // a group past the last row still joins the shuffles of its warp
  const bool valid = row < rows;
  const int nvec = d / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 raw[VPL];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int vi = lane + j * L;
    raw[j] = make_uint4(0u, 0u, 0u, 0u);
    if (valid && vi < nvec) raw[j] = __ldg(xr + vi);
    float f[E];
    unpack<TX>(raw[j], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss += f[e] * f[e];
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / float(d) + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int vi = lane + j * L;
    if (valid && vi < nvec) {
      float f[E], sc[E];
      unpack<TX>(raw[j], f);
      load_scale<TS, E>(scale + vi * E, sc);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = f[e] * r * sc[e];
      orow[vi] = pack<TX>(f);
    }
  }
}

template <typename TX, typename TS, int L, int VPL>
int launch_vec(int64_t rows, int d, const void* x, const void* scale,
               float eps, void* out, cudaStream_t stream) {
  constexpr int rows_per_block = kVecThreads / L;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  rmsnorm_vec_kernel<TX, TS, L, VPL><<<unsigned(blocks), kVecThreads, 0,
                                       stream>>>(
      rows, d, static_cast<const TX*>(x), static_cast<const TS*>(scale), eps,
      static_cast<TX*>(out));
  return int(cudaGetLastError());
}

// The vector kernel's widths: d a multiple of the vector, at most 32
// vectors a lane. Returns -1 where the scalar kernel takes the call.
template <typename TX, typename TS>
int dispatch_vec(int64_t rows, int d, const void* x, const void* scale,
                 float eps, void* out, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(TX);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(scale)) & 15) == 0;
  if (!aligned || d % E != 0) return -1;
  const int nvec = d / E;
  if (nvec <= 8) return launch_vec<TX, TS, 8, 1>(rows, d, x, scale, eps, out, stream);
  if (nvec <= 16) return launch_vec<TX, TS, 16, 1>(rows, d, x, scale, eps, out, stream);
  const int per_lane = (nvec + 31) / 32;
#define RN_VPL(V)                                                          \
  if (per_lane <= V)                                                       \
    return launch_vec<TX, TS, 32, V>(rows, d, x, scale, eps, out, stream);
  RN_VPL(1)
  RN_VPL(2)
  RN_VPL(3)
  RN_VPL(4)
  RN_VPL(6)
  RN_VPL(8)
  RN_VPL(9)
  RN_VPL(12)
  RN_VPL(16)
  RN_VPL(24)
  RN_VPL(32)
#undef RN_VPL
  return -1;
}

// ---- scalar fallback for widths the vectors cannot take ----

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
  const int vec = dispatch_vec<TX, TS>(rows, d, x, scale, eps, out, stream);
  if (vec >= 0) return vec;
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
