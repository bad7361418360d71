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
// Bound: three limits, at Jamba's prefill (Bt 4, S 1024, DI 8192, ST 16)
// with the model's types (delta and y float, u, B and C bfloat16).
// Bytes: one read of delta and u and one write of y per (t, i), ~340 MB,
// 0.10 ms at an H100 SXM's 3.35 TB/s. The 537 M expf: each is one MUFU
// ex2, and the MUFU unit retires 16 a clock per SM, 132 x 16 x 1.98 GHz
// = 4.2 T/s: 0.13 ms. Instruction issue: under --fmad=false every
// multiply and add of the update is an instruction of its own, and expf
// compiles to eight more around its ex2, so each (t, i, s) costs ~14
// issue slots, and an SM issues 4 warp instructions a clock: ~0.22 ms.
// Issue, not bytes, is the floor of this arithmetic, and the sequential
// loop over S leaves only Bt * DI independent recurrences.
//
// Design against that bound:
// - ST split across lanes. Each (batch, channel) is carried by a group of
//   G adjacent lanes (G = ST / 8 for ST > 8, else 1), each holding 8 (or
//   ST) of the states and the matching entries of A in registers. At
//   Jamba's shape that is 2 lanes per channel, twice the threads of one
//   lane per channel: 512 blocks of 128 threads, one wave of 4 per SM, up
//   to 128 registers a thread, 8 states x 16 steps of independent expf
//   unrolled per lane. Eight states a lane, not four, spread each step's
//   fixed cost (the loads of delta, u, B and C from shared memory, du,
//   the reduction of y) over twice the states.
// - h's update stays elementwise, in the plain version's operation order
//   (dA = expf(dt * a); h = dA * h + du * B, no contraction under
//   --fmad=false), so h agrees with it bit for bit.
// - y: each lane forms its partial sum over its states (fmaf); over G
//   consecutive steps the group reduce-scatters its G x G partials with
//   log2(G) rounds of __shfl_xor_sync (G - 1 shuffles for G steps), so
//   lane g ends with step g's full sum and writes it: every lane stores,
//   one y per G steps, and a warp's store covers whole 32-byte sectors.
//   y differs from the plain version only in the order of the ST-term
//   sum.
// - Loads overlap compute. Time is staged in chunks of 16 steps through a
//   double buffer in shared memory: chunk k+1's loads of delta, u, B and
//   C are issued into registers before chunk k is computed, stored into
//   the other buffer after it, and one __syncthreads per chunk remains.
//   delta and u are read as rows of a block's neighbouring channels, B
//   and C once per block and chunk. Where every operand's rows are
//   contiguous and aligned (the model's layout, B and C slices of one
//   projection included), the loads are 4-element vectors (16 bytes of
//   float, 8 of bfloat16), kept as raw bits until the stash; address
//   arithmetic of one load per element cost more issue slots than the
//   loads themselves.
// Channels past DI are masked in the kernel (the TPU wrapper padded DI to
// its block instead). Operands are read by the strides the launcher
// passes, so a strided B or C (slices of one projection) is not copied.
// Nothing is allocated here; the launch goes on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 2 };

constexpr int kThreads = 128;  // threads per block
constexpr int kChunk = 16;     // time steps per staged chunk
// States per lane, and blocks resident per SM: at Jamba's shape the grid
// is 512 blocks, one wave of 4 per SM with up to 128 registers a thread.
constexpr int kLaneStates = 8;
constexpr int kBlocksPerSm = 4;

// The split of ST over a channel's lanes.
template <int ST>
struct Split {
  static constexpr int G = ST > kLaneStates ? ST / kLaneStates : 1;
  static constexpr int P = ST / G;               // states per lane
  static constexpr int CH = kThreads / G;        // channels per block
  static_assert(kChunk % G == 0, "a chunk holds whole groups of G steps");
};

// One [Bt, S, X] operand: base pointer, element strides, storage type.
struct Operand {
  const void* p;
  int64_t sb, ss, sx;
  int bf16;
};

// One thread's share of a [kChunk][W] tile of an operand, carried in
// registers from fetch (before a chunk is computed) to stash (after it).
// Scalar: element j at row j * R + tid / W, column tid % W (R = kThreads
// / W rows per pass), converted to float on load. Vector (kVec: the
// operand's W columns are contiguous and every row starts 4-element
// aligned): 4-element vectors, 16 bytes of float or 8 of bfloat16, vector
// j at row j * R + tid / (W / 4), kept as raw bits until the stash. Rows
// at or past n, and columns at or past the operand's width, are 0.
template <int W, bool kVec>
struct Tile {
  static constexpr int kPerRow = kVec ? W / 4 : W;   // slots per row
  static constexpr int R = kThreads / kPerRow;       // rows per pass
  static constexpr int N = (kChunk * kPerRow + kThreads - 1) / kThreads;
  uint32_t raw[kVec ? 4 * N : N];

  // Issue every load of the tile whose row 0, column 0 is element `base`.
  __device__ __forceinline__ void fetch(const Operand& o, int64_t base,
                                        int n, int width, int tid) {
    const int r0 = tid / kPerRow;
    const int c = kVec ? (tid % kPerRow) * 4 : tid % kPerRow;
    const bool col_ok = c < width;
    const int64_t step = R * o.ss;
    const int64_t at = base + r0 * o.ss + c * o.sx;
    if (o.bf16) {
      const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(o.p) + at;
#pragma unroll
      for (int j = 0; j < N; ++j, p += step) {
        const bool ok = col_ok && j * R + r0 < n;
        if constexpr (kVec) {
          const uint2 x = ok ? *reinterpret_cast<const uint2*>(p)
                             : make_uint2(0u, 0u);
          raw[4 * j] = x.x;
          raw[4 * j + 1] = x.y;
        } else {
          raw[j] = __float_as_uint(ok ? __bfloat162float(*p) : 0.f);
        }
      }
    } else {
      const float* p = static_cast<const float*>(o.p) + at;
#pragma unroll
      for (int j = 0; j < N; ++j, p += step) {
        const bool ok = col_ok && j * R + r0 < n;
        if constexpr (kVec) {
          const uint4 x = ok ? *reinterpret_cast<const uint4*>(p)
                             : make_uint4(0u, 0u, 0u, 0u);
          raw[4 * j] = x.x;
          raw[4 * j + 1] = x.y;
          raw[4 * j + 2] = x.z;
          raw[4 * j + 3] = x.w;
        } else {
          raw[j] = __float_as_uint(ok ? *p : 0.f);
        }
      }
    }
  }

  // Store the fetched tile into s as float (bfloat16 widened exactly).
  __device__ __forceinline__ void stash(float (*s)[W], int bf16,
                                        int tid) const {
    const int r0 = tid / kPerRow;
    const int c = kVec ? (tid % kPerRow) * 4 : tid % kPerRow;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int row = j * R + r0;
      if (row >= kChunk) continue;
      if constexpr (kVec) {
        float4 f;
        if (bf16) {
          f = make_float4(__uint_as_float(raw[4 * j] << 16),
                          __uint_as_float(raw[4 * j] & 0xffff0000u),
                          __uint_as_float(raw[4 * j + 1] << 16),
                          __uint_as_float(raw[4 * j + 1] & 0xffff0000u));
        } else {
          f = make_float4(__uint_as_float(raw[4 * j]),
                          __uint_as_float(raw[4 * j + 1]),
                          __uint_as_float(raw[4 * j + 2]),
                          __uint_as_float(raw[4 * j + 3]));
        }
        *reinterpret_cast<float4*>(&s[row][c]) = f;
      } else {
        s[row][c] = __uint_as_float(raw[j]);
      }
    }
  }
};

// P consecutive floats of shared memory, 16-byte aligned when P is a
// multiple of 4.
template <int P>
__device__ __forceinline__ void load_p(const float* p, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int s = 0; s < P; s += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + s);
      v[s] = x.x; v[s + 1] = x.y; v[s + 2] = x.z; v[s + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < P; ++s) v[s] = p[s];
  }
}

// The lane-group reduction: q[j] holds this lane's partial of step j of G
// steps; after log2(G) rounds, q[0] holds the sum over the group's lanes
// of step g's partials. Round `half` pairs lanes g and g ^ half: each
// keeps the half of the steps whose bit `half` matches its own and sends
// the other half, so step j sums its partials as a halving tree, lanes
// (l, l + G/2) first.
__host__ __device__ constexpr int log2i(int x) {
  return x > 1 ? 1 + log2i(x / 2) : 0;
}

template <int G>
__device__ __forceinline__ void reduce_scatter(float (&q)[G], int g) {
  constexpr int kRounds = log2i(G);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int half = G >> (r + 1);
    const bool upper = (g & half) != 0;
#pragma unroll
    for (int j = 0; j < G / 2; ++j) {
      if (j < half) {
        const float send = upper ? q[j] : q[j + half];
        const float keep = upper ? q[j + half] : q[j];
        q[j] = keep + __shfl_xor_sync(0xffffffffu, send, half);
      }
    }
  }
}

// One staged chunk of n steps (n == kChunk when kFull). y_at points at
// this lane's channel in row g of the chunk's rows of y.
template <int ST, bool kFull>
__device__ __forceinline__ void scan_chunk(
    float (&h)[Split<ST>::P], const float (&a)[Split<ST>::P],
    float (*sd)[Split<ST>::CH], float (*su)[Split<ST>::CH],
    float (*sb)[ST], float (*sc)[ST], int n, int ch, int g,
    bool live, float* y_at, int64_t DI) {
  constexpr int G = Split<ST>::G, P = Split<ST>::P;
#pragma unroll
  for (int j0 = 0; j0 < kChunk; j0 += G, y_at += G * DI) {
    if (!kFull && j0 >= n) break;
    float q[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int t = j0 + j;
      q[j] = 0.f;
      if (kFull || t < n) {
        const float dt = sd[t][ch];
        const float du = dt * su[t][ch];
        float bv[P], cv[P];
        load_p<P>(&sb[t][g * P], bv);
        load_p<P>(&sc[t][g * P], cv);
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const float dA = expf(dt * a[s]);
          const float dah = dA * h[s];
          const float dbu = du * bv[s];
          h[s] = dah + dbu;
          q[j] = fmaf(h[s], cv[s], q[j]);
        }
      }
    }
    reduce_scatter<G>(q, g);
    if (live && (kFull || j0 + g < n)) *y_at = q[0];
  }
}

template <int ST, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    selective_scan_kernel(int S, int DI, Operand delta, Operand u,
                          const float* __restrict__ A, Operand bm, Operand cm,
                          const float* __restrict__ h0, float* __restrict__ y,
                          float* __restrict__ hout) {
  typedef Split<ST> Sp;
  constexpr int G = Sp::G, P = Sp::P, CH = Sp::CH;
  // the double buffer: chunk k computes from [k & 1] while chunk k+1 is
  // staged into the other
  __shared__ __align__(16) float s_delta[2][kChunk][CH];
  __shared__ __align__(16) float s_u[2][kChunk][CH];
  __shared__ __align__(16) float s_b[2][kChunk][ST];
  __shared__ __align__(16) float s_c[2][kChunk][ST];
  const int tid = threadIdx.x;
  const int g = tid % G, ch = tid / G;
  const int64_t b = blockIdx.y;
  const int i0 = blockIdx.x * CH;
  const int i = i0 + ch;
  const bool live = i < DI;

  float a[P], h[P];
  const int64_t at = int64_t(i) * ST + g * P;
  const int64_t hat = (b * DI + i) * ST + g * P;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    a[s] = live ? A[at + s] : 0.f;
    h[s] = live ? h0[hat + s] : 0.f;
  }

  const int64_t d_at = b * delta.sb + int64_t(i0) * delta.sx;
  const int64_t u_at = b * u.sb + int64_t(i0) * u.sx;
  const int64_t b_at = b * bm.sb;
  const int64_t c_at = b * cm.sb;
  Tile<CH, kVec> rd, ru;
  Tile<ST, kVec> rb, rc;
  auto fetch_chunk = [&](int t0) {
    const int n = min(kChunk, S - t0);
    rd.fetch(delta, d_at + t0 * delta.ss, n, DI - i0, tid);
    ru.fetch(u, u_at + t0 * u.ss, n, DI - i0, tid);
    rb.fetch(bm, b_at + t0 * bm.ss, n, ST, tid);
    rc.fetch(cm, c_at + t0 * cm.ss, n, ST, tid);
  };
  auto stash_chunk = [&](int buf) {
    rd.stash(s_delta[buf], delta.bf16, tid);
    ru.stash(s_u[buf], u.bf16, tid);
    rb.stash(s_b[buf], bm.bf16, tid);
    rc.stash(s_c[buf], cm.bf16, tid);
  };

  float* y_row = y + (b * S + g) * DI + i;  // row g: this lane's rows
  if (S > 0) {
    fetch_chunk(0);
    stash_chunk(0);
    __syncthreads();
  }
  for (int t0 = 0, buf = 0; t0 < S; t0 += kChunk, buf ^= 1) {
    const int n = min(kChunk, S - t0);
    const bool more = t0 + kChunk < S;
    if (more) fetch_chunk(t0 + kChunk);  // in flight during the compute
    if (n == kChunk) {
      scan_chunk<ST, true>(h, a, s_delta[buf], s_u[buf], s_b[buf], s_c[buf],
                           n, ch, g, live, y_row + int64_t(t0) * DI, DI);
    } else {
      scan_chunk<ST, false>(h, a, s_delta[buf], s_u[buf], s_b[buf],
                            s_c[buf], n, ch, g, live,
                            y_row + int64_t(t0) * DI, DI);
    }
    if (more) stash_chunk(buf ^ 1);
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < P; ++s) hout[hat + s] = h[s];
  }
}

// Whether an operand's rows are contiguous runs of 4-element vectors that
// stay aligned at every batch and step: 16 bytes for float, 8 for
// bfloat16.
bool vectors(const Operand& o) {
  const uintptr_t align = o.bf16 ? 8 : 16;
  return o.sx == 1 && o.ss % 4 == 0 && o.sb % 4 == 0 &&
         reinterpret_cast<uintptr_t>(o.p) % align == 0;
}

template <int ST>
int launch(int bt, int S, int DI, const Operand& delta, const Operand& u,
           const float* A, const Operand& bm, const Operand& cm,
           const float* h0, float* y, float* hout, cudaStream_t stream) {
  const dim3 grid((DI + Split<ST>::CH - 1) / Split<ST>::CH, bt);
  // vector loads when every operand allows them; a channel vector is
  // then wholly inside DI or wholly past it
  if constexpr (ST % 4 == 0) {
    if (DI % 4 == 0 && vectors(delta) && vectors(u) && vectors(bm) &&
        vectors(cm)) {
      selective_scan_kernel<ST, true><<<grid, kThreads, 0, stream>>>(
          S, DI, delta, u, A, bm, cm, h0, y, hout);
      return int(cudaGetLastError());
    }
  }
  selective_scan_kernel<ST, false><<<grid, kThreads, 0, stream>>>(
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
