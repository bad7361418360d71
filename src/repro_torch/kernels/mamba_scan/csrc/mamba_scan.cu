// Fused selective scan (the Mamba recurrence) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   selective_scan  <- src/repro/kernels/mamba_scan/mamba_scan.py
//                      _scan_kernel (:36), launched by selective_scan_call
//                      (:57, pl.pallas_call at :70)
//
//   h_t[b, i, :] = exp(delta[b, t, i] * A[i, :]) * h_{t-1}[b, i, :]
//                  + (delta[b, t, i] * u[b, t, i]) * B[b, t, :]
//   y[b, t, i]   = sum_s h_t[b, i, s] * C[b, t, s]
//
// from h_{-1} = h0, returning y [Bt, S, DI] and the last state h
// [Bt, DI, ST], both float. delta, u, B and C may each be float or
// bfloat16 and are converted to float on load, as the TPU kernel does; A
// and h0 are float. The discretised terms dA and dBu ([Bt, S, DI, ST])
// never leave registers: only the factors are read.
//
// Bound: per (t, i, s) one expf and six float operations, against one
// read of delta and u and one write of y per (t, i). At Jamba's prefill
// (Bt 4, S 1024, DI 8192, ST 16) with the model's types (delta and y
// float, u, B and C bfloat16) that is ~340 MB of traffic, 0.10 ms at an
// H100 SXM's 3.35 TB/s, against ~3.6 GFLOP (0.054 ms at 67 TFLOP/s) and
// 537 M expf, so bytes bound it. The other limit is the sequential loop
// over S: only Bt * DI = 32 K threads carry the recurrence.
//
// Design against that bound: one thread per (batch, channel) holds its
// ST-element state h and its row of A in registers and walks S in order.
// A block takes 128 neighbouring channels of one batch element, so the
// reads of delta and u at one time step and the write of y are coalesced
// 512-byte rows. Time is staged in chunks of 32 steps: the block first
// issues all of a chunk's loads (delta and u of its channels, B and C's ST
// values shared by the whole block) into shared memory, then computes the
// chunk from there, so a load's latency is paid once per chunk and not
// once per step. The update repeats the plain version's operation order
// (the source builds with --fmad=false), so h agrees with it bit for bit
// and y differs only in the order of the ST-term sum. Channels past DI
// are masked in the kernel (the TPU wrapper padded DI to its block
// instead). Operands are read by the strides the launcher passes, so a
// strided B or C (slices of one projection) is not copied. Nothing is
// allocated here; the launch goes on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 2 };

constexpr int kBlock = 128;  // channels per block, one thread each
constexpr int kChunk = 32;   // time steps staged in shared memory per pass

// One [Bt, S, X] operand: base pointer, element strides, storage type.
struct Operand {
  const void* p;
  int64_t sb, ss, sx;
  int bf16;
};

__device__ __forceinline__ float load(const Operand& o, int64_t i) {
  return o.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(o.p)[i])
                : static_cast<const float*>(o.p)[i];
}

template <int ST>
__global__ void __launch_bounds__(kBlock)
    selective_scan_kernel(int S, int DI, Operand delta, Operand u,
                          const float* __restrict__ A, Operand bm, Operand cm,
                          const float* __restrict__ h0, float* __restrict__ y,
                          float* __restrict__ hout) {
  __shared__ float s_delta[kChunk][kBlock];
  __shared__ float s_u[kChunk][kBlock];
  __shared__ float s_b[kChunk][ST];
  __shared__ float s_c[kChunk][ST];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int i = blockIdx.x * kBlock + tid;
  const bool live = i < DI;

  float a[ST], h[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    a[s] = live ? A[int64_t(i) * ST + s] : 0.f;
    h[s] = live ? h0[(b * DI + i) * ST + s] : 0.f;
  }
  const int64_t d_at = b * delta.sb + int64_t(i) * delta.sx;
  const int64_t u_at = b * u.sb + int64_t(i) * u.sx;
  float* y_row = y + b * S * DI + i;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is consumed
    if (live) {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (t < n) {
          s_delta[t][tid] = load(delta, d_at + int64_t(t0 + t) * delta.ss);
          s_u[t][tid] = load(u, u_at + int64_t(t0 + t) * u.ss);
        }
      }
    }
    for (int k = tid; k < n * ST; k += kBlock) {
      const int t = k / ST, s = k % ST;
      s_b[t][s] = load(bm, b * bm.sb + int64_t(t0 + t) * bm.ss + s * bm.sx);
      s_c[t][s] = load(cm, b * cm.sb + int64_t(t0 + t) * cm.ss + s * cm.sx);
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < n; ++t) {
      const float dt = s_delta[t][tid];
      const float du = dt * s_u[t][tid];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const float dA = expf(dt * a[s]);
        h[s] = dA * h[s] + du * s_b[t][s];
        acc += h[s] * s_c[t][s];
      }
      y_row[int64_t(t0 + t) * DI] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < ST; ++s) hout[(b * DI + i) * ST + s] = h[s];
  }
}

template <int ST>
int launch(int bt, int S, int DI, const Operand& delta, const Operand& u,
           const float* A, const Operand& bm, const Operand& cm,
           const float* h0, float* y, float* hout, cudaStream_t stream) {
  const dim3 grid((DI + kBlock - 1) / kBlock, bt);
  selective_scan_kernel<ST><<<grid, kBlock, 0, stream>>>(
      S, DI, delta, u, A, bm, cm, h0, y, hout);
  return int(cudaGetLastError());
}

Operand operand(const void* p, int dtype, int64_t sb, int64_t ss,
                int64_t sx) {
  return Operand{p, sb, ss, sx, dtype == kBFloat16 ? 1 : 0};
}

bool known(int dtype) { return dtype == kFloat32 || dtype == kBFloat16; }

}  // namespace

extern "C" {

// delta, u: [bt, S, DI] and B, C: [bt, S, ST] with the given element
// strides and dtype codes (0 float32, 2 bfloat16); A: [DI, ST], h0 and
// hout: [bt, DI, ST], y: [bt, S, DI], all contiguous float32.
int selective_scan_fwd(int st, int bt, int S, int DI,
                       const void* delta, int delta_dtype, int64_t d_sb,
                       int64_t d_ss, int64_t d_sx,
                       const void* u, int u_dtype, int64_t u_sb, int64_t u_ss,
                       int64_t u_sx,
                       const float* A,
                       const void* B, int b_dtype, int64_t b_sb, int64_t b_ss,
                       int64_t b_sx,
                       const void* C, int c_dtype, int64_t c_sb, int64_t c_ss,
                       int64_t c_sx,
                       const float* h0, float* y, float* hout, void* stream) {
  if (bt <= 0 || bt > 65535 || S < 0 || DI <= 0) {
    return int(cudaErrorInvalidValue);
  }
  if (!known(delta_dtype) || !known(u_dtype) || !known(b_dtype) ||
      !known(c_dtype)) {
    return int(cudaErrorInvalidValue);
  }
  const Operand od = operand(delta, delta_dtype, d_sb, d_ss, d_sx);
  const Operand ou = operand(u, u_dtype, u_sb, u_ss, u_sx);
  const Operand ob = operand(B, b_dtype, b_sb, b_ss, b_sx);
  const Operand oc = operand(C, c_dtype, c_sb, c_ss, c_sx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (st) {
    case 1: return launch<1>(bt, S, DI, od, ou, A, ob, oc, h0, y, hout, s);
    case 2: return launch<2>(bt, S, DI, od, ou, A, ob, oc, h0, y, hout, s);
    case 4: return launch<4>(bt, S, DI, od, ou, A, ob, oc, h0, y, hout, s);
    case 8: return launch<8>(bt, S, DI, od, ou, A, ob, oc, h0, y, hout, s);
    case 16: return launch<16>(bt, S, DI, od, ou, A, ob, oc, h0, y, hout, s);
    case 32: return launch<32>(bt, S, DI, od, ou, A, ob, oc, h0, y, hout, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
