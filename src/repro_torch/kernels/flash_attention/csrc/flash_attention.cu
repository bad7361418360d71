// Flash attention (forward) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   flash_attention_fwd <- src/repro/kernels/flash_attention/
//       flash_attention.py _flash_kernel (:31), launched by
//       flash_attention_call (:79, pl.pallas_call at :106)
//
// Causal (or not) grouped-query attention over q [B, Sq, H, d] and k, v
// [B, Sk, K, d] (H % K == 0; query head h reads kv head h / (H/K)), query
// i at position i and key j at position j, exactly the TPU kernel's
// function: s = (q . k) * d^-0.5, the optional logit softcap
// c * tanh(s / c), then every score outside the mask set to
// NEG_INF = -2^30 (key past Sk, key after the query when causal, key at or
// before q_pos - window when window > 0), an online softmax in float with
// running (m, l, acc), and out = acc / max(l, 1e-30) in q's dtype.
//
// Bound: causal attention does 4 * B * H * Sq * Sk * d / 2 operations (two
// products over the lower triangle) against reading q, k, v and writing
// out once. At qwen3-1.7b's prefill (B=4, S=1024, H=16, K=8, d=128) that
// is 17.2 GFLOP and 42 MB of bf16: 17.4 us at 989 TFLOP/s (the bf16 tensor
// cores) and 12.5 us at 3.35 TB/s, so the card's bound is its tensor-core
// rate.
//
// Design, a first simple version: the products run in float on the CUDA
// cores (67 TFLOP/s peak), so this kernel sits well above that bound; the
// tensor cores (mma/wgmma) and TMA loads are a later change. Grid
// (q-block of 64 rows, head, batch), 256 threads. A block keeps its Q tile
// in shared memory and streams 64-row K and V tiles through one shared
// buffer (K for the scores, then V over it for the product): 85 KB at
// d = 128, so shared memory leaves room for two blocks on an SM (the
// registers a thread takes may allow fewer). Each thread owns 4
// query rows x 4 key columns of the score tile and 4 rows x d/16 columns
// of the output; the 16 threads of a row reduce its max and sum with
// shuffles. Rows are padded by 4 floats so the 16-byte shared-memory
// reads of the score product hit distinct banks. KV tiles that lie wholly
// above the causal diagonal, or wholly before the sliding window of the
// tile's first query, are never loaded (the TPU kernel skips the former
// through its loop bound). q, k, v and out are addressed by their batch,
// sequence and head strides (the head dim contiguous), so the model's
// [B, S, H, d] tensors go in without a transpose or a copy. Shared memory
// above 48 KB is requested with the dynamic attribute. Nothing is
// allocated here; the launch goes on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 2 };

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key rows per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1073741824.0f;  // -2^30, as the TPU kernel

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <int D>
struct Tile {
  static constexpr int kRow = D + 4;      // Q and K/V tile row stride
  static constexpr int kPRow = kBK + 4;   // probability tile row stride
  static constexpr size_t kBytes =
      sizeof(float) * (size_t(kBQ) * kRow + size_t(kBK) * kRow +
                       size_t(kBQ) * kPRow);
};

// rows [row0, row0 + 64) of one head of a [*, S, *, D] tensor into a
// float tile; rows at or past s_len are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t row_stride, int row0,
                                          int s_len, float* tile) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int pos = row0 + r;
    tile[r * Tile<D>::kRow + c] =
        pos < s_len ? ld(base + int64_t(pos) * row_stride, c) : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  int64_t b, s, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int sq,
                     int sk, int group, Strides qs, Strides ks, Strides vs,
                     Strides os, float sm_scale, int causal, int window,
                     float softcap) {
  constexpr int R = Tile<D>::kRow;
  constexpr int PR = Tile<D>::kPRow;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;
  float* kv_tile = q_tile + kBQ * R;
  float* p_tile = kv_tile + kBK * R;

  const int tx = threadIdx.x & 15;   // key column / output column group
  const int ty = threadIdx.x >> 4;   // query row group
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  load_tile<T, D>(qb, qs.s, q0, sq, q_tile);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that can hold an unmasked key of this query tile
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / kBK) * kBK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's V reads are done
    load_tile<T, D>(kb, ks.s, k0, sk, kv_tile);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_tile + (ty + 16 * i) * R + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kv_tile + (tx + 16 * j) * R + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = kpos < sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        p_tile[(ty + 16 * i) * PR + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // K reads done; the probabilities are visible
    load_tile<T, D>(vb, vs.s, k0, sk, kv_tile);
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < kBK; jj += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(p_tile + (ty + 16 * i) * PR + jj);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = kv_tile[(jj + t) * R + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? p4[i].x
                          : t == 1 ? p4[i].y
                          : t == 2 ? p4[i].z
                                   : p4[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    T* orow = o + b * os.b + int64_t(qpos) * os.s + h * os.h;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) st(orow, tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(int batch, int heads, int group, int sq, int sk, const void* q,
           const void* k, const void* v, void* o, Strides qs, Strides ks,
           Strides vs, Strides os, float sm_scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kBytes;
  static bool granted = false;  // per (T, D) instantiation
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
    granted = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, group, qs, ks, vs,
      os, sm_scale, causal, window, softcap);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, int batch, int heads, int group, int sq, int sk,
               const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
               int causal, int window, float softcap, cudaStream_t stream) {
#define FLASH_D(DD)                                                        \
  case DD:                                                                 \
    return launch<T, DD>(batch, heads, group, sq, sk, q, k, v, o, qs, ks, \
                         vs, os, sm_scale, causal, window, softcap, stream);
  switch (d) {
    FLASH_D(16)
    FLASH_D(32)
    FLASH_D(64)
    FLASH_D(128)
    FLASH_D(256)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef FLASH_D
}

}  // namespace

extern "C" {

// q: [B, Sq, H, d], k/v: [B, Sk, K, d], out: [B, Sq, H, d], each with its
// head dim contiguous and its (batch, sequence, head) strides in elements;
// group = H / K; d in {16, 32, 64, 128, 256}; dtype codes 0 float32,
// 2 bfloat16 (q, k, v and out share one dtype).
int flash_attention_fwd(int dtype, int d, int batch, int heads, int group,
                        int sq, int sk, const void* q, const void* k,
                        const void* v, void* o, int64_t q_sb, int64_t q_ss,
                        int64_t q_sh, int64_t k_sb, int64_t k_ss,
                        int64_t k_sh, int64_t v_sb, int64_t v_ss,
                        int64_t v_sh, int64_t o_sb, int64_t o_ss,
                        int64_t o_sh, float sm_scale, int causal, int window,
                        float softcap, void* stream) {
  if (batch <= 0 || heads <= 0 || group <= 0 || sq <= 0 || sk <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  if (dtype == kFloat32)
    return dispatch_d<float>(d, batch, heads, group, sq, sk, q, k, v, o, qs,
                             ks, vs, os, sm_scale, causal, window, softcap, s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(d, batch, heads, group, sq, sk, q, k, v,
                                     o, qs, ks, vs, os, sm_scale, causal,
                                     window, softcap, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
