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
// Design for bfloat16 (flash_tc_kernel, one template over d in {16, 32,
// 64, 128, 256}): both products run on the tensor cores with wgmma
// (m64nNk16, bf16 in, f32 accumulate) and the tiles come in by TMA.
//  - A block owns 128 query rows of one (batch, head) as two consumer
//    warpgroups of 64 rows (64 rows and one warpgroup at d = 256, where
//    the registers bind), plus one producer warp. The producer loads the
//    Q tile once and keeps K and V tiles (128 kv rows, 64 at d = 256) in
//    flight through a 3-stage ring in shared memory, with a full and an
//    empty mbarrier per stage; setmaxnreg moves the producer's registers
//    to the consumers (24 against 240; at d = 256 each of the 256
//    threads may take 255). At d = 128: Q (32 KB) + 3 x (K + V) (192 KB)
//    = 224 KB of the 227 KB a block may hold.
//  - TMA descriptors are built on the host per call from the tensors'
//    strides (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so
//    no -lcuda) and passed as __grid_constant__ parameters: a 4-D map
//    (d, heads, seq, batch) whose box is one head's rows, so the model's
//    [B, S, H, d] tensors and transposed views go in without a copy; bases
//    and strides must be 16-byte aligned (the launcher raises otherwise).
//    Rows past Sq or Sk arrive as zeros (TMA's out-of-bounds fill) and are
//    masked as before. Shared memory rows use the 128-byte swizzle that
//    the wgmma descriptors read (64-column chunks; d = 16 and 32 use the
//    32- and 64-byte swizzles of their narrower rows).
//  - S = Q K^T reads both from shared memory (K-major, no transpose). The
//    scale, softcap and masks are applied to the S fragment in registers
//    (masks only on tiles that cross the diagonal, the window's edge or
//    Sk), then the online softmax in f32 (exp2 with log2(e) folded in;
//    row max and sum over the 4 lanes of a row with shuffles). O += P V
//    takes P from registers, re-packed from the S fragment, and V from
//    shared memory with the transpose bit (V is MN-major).
//  - Phase j of a warpgroup starts S(j) and P(j-1) V(j-1) as one group of
//    wgmma and waits once, then computes the softmax of tile j; the first
//    and last phases are peeled so that no wgmma sits on a conditional
//    path (ptxas serialises those). The two consumer warpgroups take
//    turns to start theirs (named barriers), so one's products run while the
//    other computes its softmax.
//  - Numerics: P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//    and both go through the tensor cores against the same V tile, so P
//    keeps ~16 bits (|P - P_hi - P_lo| <= 2^-16 P) and the output stays
//    within 2^-16 max|v| of the f32 computation: the same bf16 bar as the
//    f32 CUDA-core kernel, at 1.5x its tensor-core work. A single bf16 P
//    (as SDPA rounds it) would move outputs by ~2^-9 relative.
//  - KV tiles wholly above the causal diagonal or wholly before the
//    window are never loaded; the blocks run the last (heaviest) causal
//    query tiles first to cut the tail wave.
// What holds it back: the split P (1.5x the tensor-core work of one
// rounding), no overlap of a warpgroup's softmax with its own products
// (S of the next tile would need a second 64-register fragment beside O
// and P), the masked half of each diagonal tile, one block per SM (224 KB
// of shared memory), and the output leaving by plain stores.
//
// Design for float32 (flash_fwd_kernel, unchanged from the first port):
// the products run in float on the CUDA cores (67 TFLOP/s peak), since
// TF32 tensor cores keep ~3 decimal digits and would break the f32 bar.
// Grid (q-block of 64 rows, head, batch), 256 threads. A block keeps its
// Q tile in shared memory and streams 64-row K and V tiles through one
// shared buffer (K for the scores, then V over it for the product). Each
// thread owns 4 query rows x 4 key columns of the score tile and 4 rows x
// d/16 columns of the output; the 16 threads of a row reduce its max and
// sum with shuffles. q, k, v and out are addressed by their batch,
// sequence and head strides (the head dim contiguous).
//
// Nothing is allocated here; the launch goes on the caller's stream and
// returns cudaGetLastError() (or kEncodeError + the CUresult when a TMA
// descriptor cannot be built).

#include <cuda.h>
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
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }

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

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kEncodeError = 10000;  // + CUresult of cuTensorMapEncodeTiled
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumerRegs = 240;  // setmaxnreg with two consumer
constexpr int kProducerRegs = 24;   // warpgroups: 2 x 240 + 24 = 3 x 168

template <int D>
struct Cfg {
  static constexpr int kWG = D == 256 ? 1 : 2;    // consumer warpgroups
  static constexpr int kBQ = 64 * kWG;            // query rows per block
  static constexpr int kBK = D == 256 ? 64 : 128; // kv rows per tile
  static constexpr int kStages = 3;
  static constexpr int kSW = D < 64 ? D : 64;     // columns per swizzled chunk
  static constexpr int kCB = kSW * 2;             // bytes per chunk row
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;    // one K or one V tile
  static constexpr int kThreads = 128 * (kWG + 1);
  // with two consumer warpgroups the producer's registers move to them
  // (384 threads enter with 168), and their phases alternate; with one,
  // every thread may take 255
  static constexpr bool kRebalance = kWG == 2;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's
  // 1024-byte period, the tiles, then the mbarriers
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kCB == 128 ? 1 : kCB == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kCB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : kCB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                  : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of this parity has completed; a wait
// that outlasts ~2^34 clocks (seconds) traps, so a fault in the pipeline
// fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// one box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// named barriers 1 and 2 (0 is __syncthreads'): the consumer warpgroups'
// turns to start their products
constexpr int kTurnBarrier = 1;
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins a register's uses after the preceding wgmma wait
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t mdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo, uint64_t layout) {
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t((lbo >> 4) & 0x3FFF) << 16)
         | (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc);
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

// S[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// S[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// O[64 x 16] += A[64 x 16] . B[16 x 16], A in registers, B MN-major in
// shared memory (the transpose bit set).
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 32] += A[64 x 16] . B[16 x 32], A in registers, B MN-major in
// shared memory (the transpose bit set).
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit set).
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major in
// shared memory (the transpose bit set).
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 256] += A[64 x 16] . B[16 x 256], A in registers, B MN-major in
// shared memory (the transpose bit set).
template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    __nv_bfloat16* __restrict__ o, int sq, int sk, int heads,
                    int group, int batch, int n_qt, Strides os,
                    float sm_scale, int causal, int window, float softcap) {
  using C = Cfg<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, CB = C::kCB, SW = C::kSW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t kv_tiles = base + C::kQBytes;  // stage s: K, then V
  const uint32_t bars = kv_tiles + 2 * C::kStages * C::kKVBytes;
  const uint32_t q_full = bars;
  // full[s] at bars + 8 (1 + s), empty[s] at bars + 8 (1 + kStages + s)

  // heaviest query tiles first: the last causal tiles read the most keys
  const int per_tile = batch * heads;
  const int qt = n_qt - 1 - int(blockIdx.x) / per_tile;
  const int bh = int(blockIdx.x) % per_tile;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * BQ;
  // KV tiles that can hold an unmasked key of this query tile
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + BQ);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / BK) * BK;
  const int n_kv = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + C::kStages + s), 4 * C::kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::kWG) {
    // ---- producer warpgroup: one thread starts every TMA load ----
    if constexpr (C::kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    if (threadIdx.x == 128 * C::kWG) {
      const int kvh = h / group;
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < D / SW; ++c)
        tma_load(q_tile + c * BQ * CB, &mq, q_full, c * SW, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % C::kStages;
        const uint32_t full = bars + 8 * (1 + s);
        mbar_wait(bars + 8 * (1 + C::kStages + s),
                  ((j / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kKVBytes);
        const int k0 = kv_begin + j * BK;
        const uint32_t kt = kv_tiles + s * 2 * C::kKVBytes;
#pragma unroll
        for (int c = 0; c < D / SW; ++c) {
          tma_load(kt + c * BK * CB, &mk, full, c * SW, kvh, k0, b);
          tma_load(kt + C::kKVBytes + c * BK * CB, &mv, full, c * SW, kvh,
                   k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 ----
    if constexpr (C::kRebalance)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int wq0 = q0 + 64 * wg;              // first row of the warpgroup
    const int row = wq0 + 16 * warp + g;       // this thread's rows: row,
                                               // row + 8
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // P of the previous tile, as bf16 hi + lo A fragments
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    // S(j); its first k16 step overwrites it (scale-d 0)
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

    // S(j) = Q K_j^T: D / 16 steps of k16, both operands K-major
    auto mma_s = [&](int j) {
      const uint32_t kt = kv_tiles + (j % C::kStages) * 2 * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t chunk = (kk * 16) / SW, inner = ((kk * 16) % SW) * 2;
        const uint64_t da = mdesc(q_tile + chunk * BQ * CB + wg * 64 * CB +
                                      inner, 16, 8 * CB, C::kLayout);
        const uint64_t db = mdesc(kt + chunk * BK * CB + inner, 16, 8 * CB,
                                  C::kLayout);
        wgmma_ss<BK>(sc, da, db, kk > 0);
      }
    };
    // O += P(j) V_j: BK / 16 steps of k16, V MN-major (transposed)
    auto mma_pv = [&](int j) {
      const uint32_t vt =
          kv_tiles + (j % C::kStages) * 2 * C::kKVBytes + C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = mdesc(vt + kk * 16 * CB, BK * CB, 8 * CB,
                                  C::kLayout);
        wgmma_rs<D>(acc, p_hi[kk], dv);
        wgmma_rs<D>(acc, p_lo[kk], dv);
      }
    };
    // the end of a phase: its products done, tile j's K and V released
    // when P(j) V_j was among them
    auto finish = [&](int released) {
      wg_wait0();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) pin(sc[i]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pin(acc[i]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          pin(p_hi[kk][t]);
          pin(p_lo[kk][t]);
        }
      if (released >= 0) {
        __syncwarp();
        if (lane == 0)
          mbar_arrive(bars + 8 * (1 + C::kStages + released % C::kStages));
      }
    };
    // the softmax of tile j on S(j): scale, softcap and (on tiles that
    // need it) the masks, the online max and sum, P(j) as hi + lo, and O
    // rescaled. Fragment element i sits at row row + 8 ((i >> 1) & 1),
    // column 8 (i >> 2) + 2 c4 + (i & 1) of the tile.
    auto softmax = [&](int j) {
      const int k0 = kv_begin + j * BK;
      const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > wq0) ||
                          (window > 0 && k0 <= wq0 + 63 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = sc[i] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (masked) {
          const int qpos = row + 8 * ((i >> 1) & 1);
          const int kpos = k0 + 8 * (i >> 2) + 2 * c4 + (i & 1);
          bool keep = kpos < sk;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
          x = keep ? x : kNegInf;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      // exp(x - m) as exp2(x log2(e) - m log2(e)): one FFMA and one ex2
      float alpha[2], rs[2] = {0.f, 0.f}, ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        ml[r] = -mx[r] * kLog2e;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 8 * kk + 2 * t;
          const float x0 = exp2f(fmaf(sc[i], kLog2e, ml[t & 1]));
          const float x1 = exp2f(fmaf(sc[i + 1], kLog2e, ml[t & 1]));
          rs[t & 1] += x0 + x1;
          __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][t] = *reinterpret_cast<uint32_t*>(&hi);
          p_lo[kk][t] = bf16x2(x0 - hf.x, x1 - hf.y);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    auto wait_tile = [&](int j) {
      mbar_wait(bars + 8 * (1 + j % C::kStages), (j / C::kStages) & 1);
    };
    // With two consumer warpgroups their phases alternate (named barriers
    // kTurnBarrier + wg): one warpgroup's products run while the other
    // computes its softmax. Warpgroup 1 has no successor after its last
    // phase.
    auto my_turn = [&]() {
      if constexpr (C::kRebalance) named_sync(kTurnBarrier + wg, 256);
    };
    auto pass_turn = [&](bool last) {
      if constexpr (C::kRebalance) {
        if (wg == 0 || !last) named_arrive(kTurnBarrier + (wg ^ 1), 256);
      }
    };

    mbar_wait(q_full, 0);
    if (n_kv > 0) {
      if constexpr (C::kRebalance) {
        if (wg == 1) named_arrive(kTurnBarrier, 256);  // warpgroup 0 first
      }
      // phase 0: S(0)
      wait_tile(0);
      my_turn();
      wg_fence();
      mma_s(0);
      wg_commit();
      pass_turn(false);
      finish(-1);
      softmax(0);
      // phase j: S(j) and P(j-1) V_(j-1) as one group of products
      for (int j = 1; j < n_kv; ++j) {
        wait_tile(j);
        my_turn();
        wg_fence();
        mma_s(j);
        mma_pv(j - 1);
        wg_commit();
        pass_turn(false);
        finish(j - 1);
        softmax(j);
      }
      // the last phase: P(n-1) V_(n-1)
      my_turn();
      wg_fence();
      mma_pv(n_kv - 1);
      wg_commit();
      pass_turn(true);
      finish(n_kv - 1);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int qpos = row + 8 * r;
      if (qpos < sq) {
        const int col = 8 * (i >> 2) + 2 * c4;
        __nv_bfloat16* dst =
            o + b * os.b + int64_t(qpos) * os.s + h * os.h + col;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[i] / l[r], acc[i + 1] / l[r]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (d, heads, seq, batch) of a bf16 tensor with its head dim
// contiguous; strides in elements; the box is `rows` sequence positions
// by `cols` head-dim columns of one (batch, head).
int encode(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
           int batch, Strides st, int cols, int rows,
           CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(st.h) * 2, cuuint64_t(st.s) * 2,
                                 cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + int(r);
}

template <int D>
int launch_tc(int batch, int heads, int group, int sq, int sk, const void* q,
              const void* k, const void* v, void* o, Strides qs, Strides ks,
              Strides vs, Strides os, float sm_scale, int causal, int window,
              float softcap, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool granted = false;  // per d
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(C::kSmem));
    if (e != cudaSuccess) return int(e);
    granted = true;
  }
  CUtensorMap mq, mk, mv;
  const int kvh = heads / group;
  int rc = encode(&mq, q, D, heads, sq, batch, qs, C::kSW, C::kBQ,
                  C::kSwizzle);
  if (rc == 0)
    rc = encode(&mk, k, D, kvh, sk, batch, ks, C::kSW, C::kBK, C::kSwizzle);
  if (rc == 0)
    rc = encode(&mv, v, D, kvh, sk, batch, vs, C::kSW, C::kBK, C::kSwizzle);
  if (rc != 0) return rc;
  const int n_qt = (sq + C::kBQ - 1) / C::kBQ;
  const int64_t blocks = int64_t(n_qt) * batch * heads;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  flash_tc_kernel<D><<<unsigned(blocks), C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), sq, sk, heads, group,
      batch, n_qt, os, sm_scale, causal, window, softcap);
  return int(cudaGetLastError());
}

int dispatch_tc(int d, int batch, int heads, int group, int sq, int sk,
                const void* q, const void* k, const void* v, void* o,
                Strides qs, Strides ks, Strides vs, Strides os,
                float sm_scale, int causal, int window, float softcap,
                cudaStream_t stream) {
#define FLASH_TC(DD)                                                        \
  case DD:                                                                  \
    return launch_tc<DD>(batch, heads, group, sq, sk, q, k, v, o, qs, ks,  \
                         vs, os, sm_scale, causal, window, softcap, stream);
  switch (d) {
    FLASH_TC(16)
    FLASH_TC(32)
    FLASH_TC(64)
    FLASH_TC(128)
    FLASH_TC(256)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef FLASH_TC
}

}  // namespace

extern "C" {

// q: [B, Sq, H, d], k/v: [B, Sk, K, d], out: [B, Sq, H, d], each with its
// head dim contiguous and its (batch, sequence, head) strides in elements;
// group = H / K; d in {16, 32, 64, 128, 256}; dtype codes 0 float32 (the
// CUDA-core kernel), 2 bfloat16 (the tensor-core kernel: q, k, v 16-byte
// aligned with strides of multiples of 8 elements); q, k, v and out share
// one dtype.
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
    return dispatch_tc(d, batch, heads, group, sq, sk, q, k, v, o, qs, ks,
                       vs, os, sm_scale, causal, window, softcap, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
