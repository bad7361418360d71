// Fused ALF state-update kernels for Hopper (sm_90a), plain C interface.
//
// What each function replaces (the Pallas TPU kernels of the JAX package):
//   alf_midpoint  <- src/repro/kernels/alf_step/alf_step.py _midpoint_kernel
//                    (:43), launched by midpoint_call (:177)
//   alf_update    <- _update_kernel (:50), update_call (:182)
//   alf_bwd_pre   <- _bwd_pre_kernel (:107), bwd_pre_call (:212)
//   alf_bwd_post  <- _bwd_post_kernel (:118), bwd_post_call (:218)
//   alf_midpoint_vjp <- _midpoint_vjp_kernel (:91), midpoint_vjp_call (:200)
//   alf_update_vjp   <- _update_vjp_kernel (:97), update_vjp_call (:206)
//   alf_inverse      <- _inverse_kernel (:75), inverse_call (:194)
//   alf_inverse_update <- _inverse_update_kernel (:61),
//                         inverse_update_call (:188)
//
// Bound: every kernel is a single elementwise pass with a handful of
// flops per element, so it is bound by memory traffic. Bytes moved per
// element (f32 storage) are 4 x (inputs + outputs): midpoint 2+1 -> 12 B,
// update 3+2 -> 20 B, bwd_pre 4+2 -> 24 B, bwd_post 6+4 -> 40 B. At the
// main path's state (2048 x 64 f32) and 3.35 TB/s (H100 SXM) that is
// 0.47 / 0.78 / 0.94 / 1.57 us, far below a launch's own cost; at 2^25
// elements it is 120 / 200 / 240 / 401 us. The direct-backprop and
// inverse kernels: midpoint_vjp 1+1 -> 8 B, update_vjp 2+2 -> 16 B,
// inverse 3+2 -> 20 B, inverse_update 3+2 -> 20 B; 0.31 / 0.63 / 0.78 /
// 0.78 us at 2048 x 64 and 80 / 160 / 200 / 200 us at 2^25. The forward
// pair at the LM paths' f32 ALF states (qwen3-1.7b 4 x 1024 x 2048 =
// 8,388,608 elements; jamba-v0.1-52b 4 x 1024 x 4096 = 16,777,216):
// midpoint 30 / 60 us, update 50 / 100 us. The one PyTorch call each is
// held against: torch.addcmul(z, v, sign*h/2) for the midpoint and
// torch.mul(g, sign*h/2) for its VJP; none for the update (two outputs).
//
// Design against that bound. The forward pair (alf_midpoint, alf_update)
// and alf_midpoint_vjp, the three kernels on the paths that launch most,
// are one vector kernel (vec_kernel) over an elementwise functor: 16-byte
// vectors (4 float, 8 bfloat16 or 2 double), up to kVecUnroll in flight
// per thread, on a grid of at most kVecBlocksPerSm blocks per SM and one
// vector a thread on small buffers. The outputs are fresh buffers and
// share one offset from a 16-byte boundary (the launch refuses outputs
// that do not); the elements before their first boundary and after their
// last whole vector go one by one, by the grid's first threads. Each
// input is read by vectors where it sits at the outputs' offset from a
// 16-byte boundary, else element by element (nothing is copied to align
// it). That choice is made per input by a template bit mask, one
// instantiation per mask (2, 4 and 8 for one, two and three inputs), so
// the aligned case, the op layer's, runs straight-line code with no
// per-element test; a runtime flag would cost nothing in divergence
// (it is uniform) but would keep both load paths in every kernel. The
// other kernels are one pass over one flat contiguous buffer, coalesced,
// with a grid-stride loop and a masked tail. The TPU's [rows, 128] lane
// layout and its padding to a block multiple are not carried over; the op
// layer packs the whole state pytree into one buffer. The step size h is
// read through a device pointer, so an adaptive controller that computes
// h on the card never syncs the host. Nothing is allocated here; each
// call is one launch on the caller's stream and returns
// cudaGetLastError().
//
// Per-row step size (PerSample batching: each sample of a batch takes its
// own adaptive step). Every entry takes h and a row length D: D == 0 is
// the scalar h above, D > 0 a (B,) h over a buffer packed row-major,
// element e using h[e / D]. Each kernel is a template on that choice, so
// the scalar instantiation is the code and the time it was. The row of
// an element comes from a double-precision reciprocal of D computed on
// the host and one correction either way (exact for e < 2^50), not from
// a 64-bit integer division. The scalar-loop kernels take one element a
// thread below 2^28 elements, so each finds its row once. The vector
// kernel finds the row of a vector's first element once a vector: a
// vector inside one row takes one h, and a vector that straddles rows
// (D % V != 0, as the CNF's D = 1570 and the tests' D = 1 and 2 give)
// walks its elements with a row counter. The per-row h adds B reads of
// the compute dtype to the bytes a call moves.
//
// Numerics: storage is float, double or bfloat16; arithmetic runs in float
// (double for double storage) in the operation order of ref.py, and the
// library is built with --fmad=false so no a*b+c is contracted. bf16 is
// written with __float2bfloat16 (round to nearest even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kFloat32 = 0, kFloat64 = 1, kBFloat16 = 2 };

template <typename T> struct Acc { typedef float type; };
template <> struct Acc<double> { typedef double type; };

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ double ld(const double* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float x) { p[i] = x; }
__device__ __forceinline__ void st(double* p, int64_t i, double x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16(x);
}

constexpr int kThreads = 256;

inline unsigned int n_blocks(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 20;  // grid-stride beyond this
  return static_cast<unsigned int>(b < cap ? b : cap);
}

// The vector kernel's grid: a few blocks per SM, grid-stride beyond.
constexpr int kVecUnroll = 4;      // 16-byte vectors in flight per thread
constexpr int kVecBlocksPerSm = 8;

#define GRID_STRIDE(i, n)                                                  \
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < (n); \
       i += int64_t(gridDim.x) * blockDim.x)

// The row of element e in a buffer of rows of `len` elements: a product
// with the host's reciprocal `inv`, corrected by one either way.
struct Rows {
  int64_t len;
  double inv;
  __device__ __forceinline__ int64_t operator()(int64_t e) const {
    int64_t r = static_cast<int64_t>(static_cast<double>(e) * inv);
    if (r * len > e) {
      --r;
    } else if ((r + 1) * len <= e) {
      ++r;
    }
    return r;
  }
};

// h/2 of element i: the scalar's, or its row's.
template <bool kRows, typename A>
__device__ __forceinline__ A half_h(const A* __restrict__ h, A scalar_hh,
                                    const Rows& rows, int64_t i) {
  if (kRows) return h[rows(i)] * A(0.5);
  return scalar_hh;
}

// psi^-1's velocity: 2*u1 - v_out (eta == 1) or (v_out - 2*eta*u1)/(1-2*eta)
template <typename A>
__device__ __forceinline__ A inverse_velocity(A vo, A u, A two_eta, A one_m,
                                              int exact) {
  if (exact) {
    const A two_u = A(2) * u;
    return two_u - vo;
  }
  const A eu = two_eta * u;
  return (vo - eu) / one_m;
}

// The elementwise functions of the vector kernel: kIn inputs to kOut
// outputs per element, in the compute dtype A, built once per thread from
// h and the call's sign or eta.

// k1 = z + sign * v * (h/2)
template <typename T>
struct MidpointOp {
  typedef typename Acc<T>::type A;
  static constexpr int kIn = 2, kOut = 1;   // (z, v) -> k1
  A s, hh;
  __device__ MidpointOp(A h, double sign)
      : s(static_cast<A>(sign)), hh(h * A(0.5)) {}
  __device__ __forceinline__ void set_h(A h) { hh = h * A(0.5); }
  __device__ __forceinline__ void operator()(const A* x, A* y) const {
    const A sv = s * x[1];
    y[0] = x[0] + sv * hh;
  }
};

// v_out = v + 2*eta*(u1 - v);  z_out = k1 + v_out * (h/2)
template <typename T>
struct UpdateOp {
  typedef typename Acc<T>::type A;
  static constexpr int kIn = 3, kOut = 2;   // (k1, v, u1) -> (z_out, v_out)
  A hh, two_eta;
  __device__ UpdateOp(A h, double eta)
      : hh(h * A(0.5)), two_eta(static_cast<A>(2.0 * eta)) {}
  __device__ __forceinline__ void set_h(A h) { hh = h * A(0.5); }
  __device__ __forceinline__ void operator()(const A* x, A* y) const {
    const A vi = x[1];
    const A du = x[2] - vi;
    const A vo = vi + two_eta * du;
    y[1] = vo;
    y[0] = x[0] + vo * hh;
  }
};

// v_bar = sign * g * (h/2)
template <typename T>
struct MidpointVjpOp {
  typedef typename Acc<T>::type A;
  static constexpr int kIn = 1, kOut = 1;   // g -> v_bar
  A s, hh;
  __device__ MidpointVjpOp(A h, double sign)
      : s(static_cast<A>(sign)), hh(h * A(0.5)) {}
  __device__ __forceinline__ void set_h(A h) { hh = h * A(0.5); }
  __device__ __forceinline__ void operator()(const A* x, A* y) const {
    const A sg = s * x[0];
    y[0] = sg * hh;
  }
};

// k1 = z - v * (h/2);  cot_u1 = 2*eta * (a_v + a_z * (h/2))
template <typename T, bool kRows>
__global__ void bwd_pre_kernel(int64_t n, const T* __restrict__ z,
                               const T* __restrict__ v,
                               const T* __restrict__ a_z,
                               const T* __restrict__ a_v,
                               const typename Acc<T>::type* __restrict__ h,
                               Rows rows, double eta, T* __restrict__ k1,
                               T* __restrict__ cot_u1) {
  typedef typename Acc<T>::type A;
  const A hh0 = kRows ? A(0) : *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  GRID_STRIDE(i, n) {
    const A hh = half_h<kRows>(h, hh0, rows, i);
    const A vh = ld(v, i) * hh;
    st(k1, i, ld(z, i) - vh);
    const A azh = ld(a_z, i) * hh;
    const A cv = ld(a_v, i) + azh;
    st(cot_u1, i, two_eta * cv);
  }
}

// v_prev = 2*u1 - v_out (eta == 1) or (v_out - 2*eta*u1) / (1 - 2*eta);
// z_prev = k1 - v_prev * (h/2);  dz = a_z + dk1;
// dv = dz * (h/2) + (1 - 2*eta) * (a_v + a_z * (h/2))
template <typename T, bool kRows>
__global__ void bwd_post_kernel(int64_t n, const T* __restrict__ k1,
                                const T* __restrict__ v_out,
                                const T* __restrict__ u1,
                                const T* __restrict__ a_z,
                                const T* __restrict__ a_v,
                                const T* __restrict__ dk1,
                                const typename Acc<T>::type* __restrict__ h,
                                Rows rows, double eta, int exact,
                                T* __restrict__ z_prev, T* __restrict__ v_prev,
                                T* __restrict__ dz, T* __restrict__ dv) {
  typedef typename Acc<T>::type A;
  const A hh0 = kRows ? A(0) : *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  const A one_m = static_cast<A>(1.0 - 2.0 * eta);
  GRID_STRIDE(i, n) {
    const A hh = half_h<kRows>(h, hh0, rows, i);
    const A vp = inverse_velocity(ld(v_out, i), ld(u1, i), two_eta, one_m,
                                  exact);
    st(v_prev, i, vp);
    const A vph = vp * hh;
    st(z_prev, i, ld(k1, i) - vph);
    const A az = ld(a_z, i);
    const A ck = az + ld(dk1, i);
    st(dz, i, ck);
    const A azh = az * hh;
    const A cv = ld(a_v, i) + azh;
    const A ckh = ck * hh;
    const A mcv = one_m * cv;
    st(dv, i, ckh + mcv);
  }
}

// v_in = inverse_velocity(v_out, u1);  z_in = k1 - v_in * (h/2)
template <typename T, bool kRows>
__global__ void inverse_update_kernel(int64_t n, const T* __restrict__ k1,
                                      const T* __restrict__ v_out,
                                      const T* __restrict__ u1,
                                      const typename Acc<T>::type* __restrict__ h,
                                      Rows rows, double eta, int exact,
                                      T* __restrict__ z_in,
                                      T* __restrict__ v_in) {
  typedef typename Acc<T>::type A;
  const A hh0 = kRows ? A(0) : *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  const A one_m = static_cast<A>(1.0 - 2.0 * eta);
  GRID_STRIDE(i, n) {
    const A hh = half_h<kRows>(h, hh0, rows, i);
    const A vi = inverse_velocity(ld(v_out, i), ld(u1, i), two_eta, one_m,
                                  exact);
    st(v_in, i, vi);
    const A vih = vi * hh;
    st(z_in, i, ld(k1, i) - vih);
  }
}

// k1 = z_out - v_out * (h/2);  v_in = inverse_velocity(v_out, u1);
// z_in = k1 - v_in * (h/2)
template <typename T, bool kRows>
__global__ void inverse_kernel(int64_t n, const T* __restrict__ z_out,
                               const T* __restrict__ v_out,
                               const T* __restrict__ u1,
                               const typename Acc<T>::type* __restrict__ h,
                               Rows rows, double eta, int exact,
                               T* __restrict__ z_in, T* __restrict__ v_in) {
  typedef typename Acc<T>::type A;
  const A hh0 = kRows ? A(0) : *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  const A one_m = static_cast<A>(1.0 - 2.0 * eta);
  GRID_STRIDE(i, n) {
    const A hh = half_h<kRows>(h, hh0, rows, i);
    const A vo = ld(v_out, i);
    const A voh = vo * hh;
    const A k = ld(z_out, i) - voh;
    const A vi = inverse_velocity(vo, ld(u1, i), two_eta, one_m, exact);
    st(v_in, i, vi);
    const A vih = vi * hh;
    st(z_in, i, k - vih);
  }
}

template <typename T, int N> struct In { const T* p[N]; };
template <typename T, int N> struct Out { T* p[N]; };

// One 16-byte vector (V elements) of an input at vector index j: one
// 16-byte load where the input sits at the outputs' 16-byte offset (vec),
// else V element loads. vec is a compile-time constant once the callers'
// loops over inputs are unrolled.
template <typename T>
__device__ __forceinline__ uint4 ld_vec(const T* __restrict__ p, int64_t j,
                                        bool vec) {
  constexpr int V = 16 / sizeof(T);
  uint4 x;
  if (vec) {
    x = reinterpret_cast<const uint4*>(p)[j];
  } else {
    T* e = reinterpret_cast<T*>(&x);
#pragma unroll
    for (int c = 0; c < V; ++c) e[c] = p[j * V + c];
  }
  return x;
}

// y = Op(x) elementwise over n elements, by 16-byte vectors of V elements:
// the outputs' first `head` elements (up to their first 16-byte boundary)
// and their last (n - head) % V are written one by one, by the grid's
// first threads; the vectors between go through a grid-stride loop, one
// vector per thread on a small buffer and kVecUnroll in flight per thread
// once the grid is capped at kVecBlocksPerSm blocks per SM. Input i is
// read by vectors when bit i of kVecMask is set (it sits at the outputs'
// offset from a 16-byte boundary), else element by element. With kRows
// the Op takes its row's h: once for a vector inside one row, element by
// element (a row counter) for a vector that straddles rows.
template <typename Op, typename T, int NI, int NO>
__device__ __forceinline__ void apply_elem(const Op& op, const uint4* r,
                                           uint4* w, int c) {
  typedef typename Op::A A;
  A x[NI], y[NO];
#pragma unroll
  for (int i = 0; i < NI; ++i) x[i] = ld(reinterpret_cast<const T*>(&r[i]), c);
  op(x, y);
#pragma unroll
  for (int o = 0; o < NO; ++o) st(reinterpret_cast<T*>(&w[o]), c, y[o]);
}

template <template <typename> class OpT, typename T, int kVecMask,
          bool kRows>
__global__ void __launch_bounds__(kThreads)
    vec_kernel(int64_t n, int64_t head, In<T, OpT<T>::kIn> in,
               Out<T, OpT<T>::kOut> out,
               const typename Acc<T>::type* __restrict__ h, Rows rows,
               double param) {
  typedef OpT<T> Op;
  typedef typename Op::A A;
  constexpr int NI = Op::kIn, NO = Op::kOut, V = 16 / sizeof(T);
  Op op(*h, param);
  const int64_t nv = (n - head) / V;
  const int64_t body_end = head + nv * V;
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t edge = t < head ? t : body_end + (t - head);
  if (edge < n && (t < head || edge >= body_end)) {
    if (kRows) op.set_h(h[rows(edge)]);
    A x[NI], y[NO];
#pragma unroll
    for (int i = 0; i < NI; ++i) x[i] = ld(in.p[i], edge);
    op(x, y);
#pragma unroll
    for (int o = 0; o < NO; ++o) st(out.p[o], edge, y[o]);
  }
  const T* iv[NI];
  T* ov[NO];
#pragma unroll
  for (int i = 0; i < NI; ++i) iv[i] = in.p[i] + head;
#pragma unroll
  for (int o = 0; o < NO; ++o) ov[o] = out.p[o] + head;
  const int64_t threads = int64_t(gridDim.x) * blockDim.x;
  for (int64_t j0 = t; j0 < nv; j0 += threads * kVecUnroll) {
    uint4 r[kVecUnroll][NI];
#pragma unroll
    for (int k = 0; k < kVecUnroll; ++k) {
      const int64_t j = j0 + k * threads;
      if (j < nv) {
#pragma unroll
        for (int i = 0; i < NI; ++i)
          r[k][i] = ld_vec(iv[i], j, (kVecMask >> i) & 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecUnroll; ++k) {
      const int64_t j = j0 + k * threads;
      if (j < nv) {
        uint4 w[NO];
        if (kRows) {
          const int64_t e = head + j * V;
          int64_t row = rows(e);
          int64_t at = e - row * rows.len;
          if (at + V <= rows.len) {
            op.set_h(h[row]);
#pragma unroll
            for (int c = 0; c < V; ++c)
              apply_elem<Op, T, NI, NO>(op, r[k], w, c);
          } else {
#pragma unroll
            for (int c = 0; c < V; ++c, ++at) {
              if (at == rows.len) {
                at = 0;
                ++row;
              }
              op.set_h(h[row]);
              apply_elem<Op, T, NI, NO>(op, r[k], w, c);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c)
            apply_elem<Op, T, NI, NO>(op, r[k], w, c);
        }
#pragma unroll
        for (int o = 0; o < NO; ++o) reinterpret_cast<uint4*>(ov[o])[j] = w[o];
      }
    }
  }
}

// c = g_v + g_z * (h/2);  v_bar = (1 - 2*eta) * c;  u1_bar = 2*eta * c
template <typename T, bool kRows>
__global__ void update_vjp_kernel(int64_t n, const T* __restrict__ g_z,
                                  const T* __restrict__ g_v,
                                  const typename Acc<T>::type* __restrict__ h,
                                  Rows rows, double eta,
                                  T* __restrict__ v_bar,
                                  T* __restrict__ u1_bar) {
  typedef typename Acc<T>::type A;
  const A hh0 = kRows ? A(0) : *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  const A one_m = static_cast<A>(1.0 - 2.0 * eta);
  GRID_STRIDE(i, n) {
    const A hh = half_h<kRows>(h, hh0, rows, i);
    const A gzh = ld(g_z, i) * hh;
    const A c = ld(g_v, i) + gzh;
    st(v_bar, i, one_m * c);
    st(u1_bar, i, two_eta * c);
  }
}

// The cached SM count of the current device (the vector kernels' grid).
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 1;
  }
  return cached[dev];
}

// Launch vec_kernel<OpT, T, mask, kRows> for the runtime mask, by
// recursion over the 2^kIn instantiations.
template <template <typename> class OpT, typename T, bool kRows, int M>
void launch_mask(int mask, unsigned int grid, cudaStream_t s, int64_t n,
                 int64_t head, const In<T, OpT<T>::kIn>& in,
                 const Out<T, OpT<T>::kOut>& out,
                 const typename Acc<T>::type* h, Rows rows, double param) {
  if constexpr (M + 1 < (1 << OpT<T>::kIn)) {
    if (mask != M) {
      launch_mask<OpT, T, kRows, M + 1>(mask, grid, s, n, head, in, out, h,
                                        rows, param);
      return;
    }
  }
  vec_kernel<OpT, T, M, kRows><<<grid, kThreads, 0, s>>>(n, head, in, out, h,
                                                          rows, param);
}

// The row geometry of a call: len 0 is a scalar h.
inline Rows make_rows(int64_t len) {
  Rows r;
  r.len = len;
  r.inv = len > 0 ? 1.0 / static_cast<double>(len) : 0.0;
  return r;
}

// One vector-kernel launch: the outputs' shared 16-byte offset sets the
// head, each input's own offset its bit of the mask, the row length the
// scalar or per-row instantiation.
template <template <typename> class OpT, typename T>
int launch_vec(int64_t n, const void* const* ins, void* const* outs,
               const void* h, int64_t row, double param, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  constexpr int NI = OpT<T>::kIn, NO = OpT<T>::kOut;
  constexpr int64_t V = 16 / sizeof(T);
  const uintptr_t out0 = reinterpret_cast<uintptr_t>(outs[0]);
  In<T, NI> in;
  Out<T, NO> out;
  int mask = 0;
  for (int i = 0; i < NI; ++i) {
    in.p[i] = static_cast<const T*>(ins[i]);
    if (((reinterpret_cast<uintptr_t>(ins[i]) ^ out0) & 15) == 0)
      mask |= 1 << i;
  }
  for (int o = 0; o < NO; ++o) {
    if (((reinterpret_cast<uintptr_t>(outs[o]) ^ out0) & 15) != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    out.p[o] = static_cast<T*>(outs[o]);
  }
  int64_t head = int64_t((16 - (out0 & 15)) & 15) / int64_t(sizeof(T));
  head = head < n ? head : n;
  const int64_t nv = (n - head) / V;
  int64_t blocks = (nv + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(kVecBlocksPerSm) * sm_count();
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks > 0 ? blocks : 1;  // the edges, and one launch per call
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const A* hp = static_cast<const A*>(h);
  if (row > 0) {
    launch_mask<OpT, T, true, 0>(mask, grid, s, n, head, in, out, hp,
                                 make_rows(row), param);
  } else {
    launch_mask<OpT, T, false, 0>(mask, grid, s, n, head, in, out, hp,
                                  make_rows(0), param);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of a scalar-loop kernel, its scalar or per-row instantiation.
#define LAUNCH_LOOP(kernel, T, row, s, n, ...)                              \
  do {                                                                      \
    if ((row) > 0) {                                                        \
      kernel<T, true><<<n_blocks(n), kThreads, 0, s>>>(__VA_ARGS__);        \
    } else {                                                                \
      kernel<T, false><<<n_blocks(n), kThreads, 0, s>>>(__VA_ARGS__);       \
    }                                                                       \
  } while (0)

template <typename T>
int launch_midpoint(int64_t n, const void* z, const void* v, const void* h,
                    int64_t row, double sign, void* k1, cudaStream_t s) {
  const void* ins[2] = {z, v};
  void* outs[1] = {k1};
  return launch_vec<MidpointOp, T>(n, ins, outs, h, row, sign, s);
}

template <typename T>
int launch_update(int64_t n, const void* k1, const void* v, const void* u1,
                  const void* h, int64_t row, double eta, void* z_out,
                  void* v_out, cudaStream_t s) {
  const void* ins[3] = {k1, v, u1};
  void* outs[2] = {z_out, v_out};
  return launch_vec<UpdateOp, T>(n, ins, outs, h, row, eta, s);
}

template <typename T>
int launch_bwd_pre(int64_t n, const void* z, const void* v, const void* a_z,
                   const void* a_v, const void* h, int64_t row, double eta,
                   void* k1, void* cot_u1, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  LAUNCH_LOOP(bwd_pre_kernel, T, row, s, n,
      n, static_cast<const T*>(z), static_cast<const T*>(v),
      static_cast<const T*>(a_z), static_cast<const T*>(a_v),
      static_cast<const A*>(h), make_rows(row), eta, static_cast<T*>(k1),
      static_cast<T*>(cot_u1));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_post(int64_t n, const void* k1, const void* v_out,
                    const void* u1, const void* a_z, const void* a_v,
                    const void* dk1, const void* h, int64_t row, double eta,
                    void* z_prev, void* v_prev, void* dz, void* dv,
                    cudaStream_t s) {
  typedef typename Acc<T>::type A;
  LAUNCH_LOOP(bwd_post_kernel, T, row, s, n,
      n, static_cast<const T*>(k1), static_cast<const T*>(v_out),
      static_cast<const T*>(u1), static_cast<const T*>(a_z),
      static_cast<const T*>(a_v), static_cast<const T*>(dk1),
      static_cast<const A*>(h), make_rows(row), eta, eta == 1.0 ? 1 : 0,
      static_cast<T*>(z_prev), static_cast<T*>(v_prev), static_cast<T*>(dz),
      static_cast<T*>(dv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inverse(int64_t n, const void* z_out, const void* v_out,
                   const void* u1, const void* h, int64_t row, double eta,
                   void* z_in, void* v_in, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  LAUNCH_LOOP(inverse_kernel, T, row, s, n,
      n, static_cast<const T*>(z_out), static_cast<const T*>(v_out),
      static_cast<const T*>(u1), static_cast<const A*>(h), make_rows(row),
      eta,
      eta == 1.0 ? 1 : 0, static_cast<T*>(z_in), static_cast<T*>(v_in));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inverse_update(int64_t n, const void* k1, const void* v_out,
                          const void* u1, const void* h, int64_t row,
                          double eta, void* z_in, void* v_in,
                          cudaStream_t s) {
  typedef typename Acc<T>::type A;
  LAUNCH_LOOP(inverse_update_kernel, T, row, s, n,
      n, static_cast<const T*>(k1), static_cast<const T*>(v_out),
      static_cast<const T*>(u1), static_cast<const A*>(h), make_rows(row),
      eta,
      eta == 1.0 ? 1 : 0, static_cast<T*>(z_in), static_cast<T*>(v_in));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_midpoint_vjp(int64_t n, const void* g, const void* h,
                        int64_t row, double sign, void* v_bar,
                        cudaStream_t s) {
  const void* ins[1] = {g};
  void* outs[1] = {v_bar};
  return launch_vec<MidpointVjpOp, T>(n, ins, outs, h, row, sign, s);
}

template <typename T>
int launch_update_vjp(int64_t n, const void* g_z, const void* g_v,
                      const void* h, int64_t row, double eta, void* v_bar,
                      void* u1_bar, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  LAUNCH_LOOP(update_vjp_kernel, T, row, s, n,
      n, static_cast<const T*>(g_z), static_cast<const T*>(g_v),
      static_cast<const A*>(h), make_rows(row), eta, static_cast<T*>(v_bar),
      static_cast<T*>(u1_bar));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DISPATCH(dtype, fn, ...)                                      \
  switch (dtype) {                                                    \
    case kFloat32: return fn<float>(__VA_ARGS__);                     \
    case kFloat64: return fn<double>(__VA_ARGS__);                    \
    case kBFloat16: return fn<__nv_bfloat16>(__VA_ARGS__);            \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

extern "C" {

// Every entry: h is a device pointer to a scalar (row == 0) or to B step
// sizes over rows of `row` elements (n == B * row).

int alf_midpoint(int dtype, int64_t n, const void* z, const void* v,
                 const void* h, int64_t row, double sign, void* k1,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_midpoint, n, z, v, h, row, sign, k1, s)
}

int alf_update(int dtype, int64_t n, const void* k1, const void* v,
               const void* u1, const void* h, int64_t row, double eta,
               void* z_out, void* v_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_update, n, k1, v, u1, h, row, eta, z_out, v_out, s)
}

int alf_bwd_pre(int dtype, int64_t n, const void* z, const void* v,
                const void* a_z, const void* a_v, const void* h, int64_t row,
                double eta, void* k1, void* cot_u1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_bwd_pre, n, z, v, a_z, a_v, h, row, eta, k1,
           cot_u1, s)
}

int alf_bwd_post(int dtype, int64_t n, const void* k1, const void* v_out,
                 const void* u1, const void* a_z, const void* a_v,
                 const void* dk1, const void* h, int64_t row, double eta,
                 void* z_prev, void* v_prev, void* dz, void* dv,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_bwd_post, n, k1, v_out, u1, a_z, a_v, dk1, h, row,
           eta, z_prev, v_prev, dz, dv, s)
}

int alf_inverse(int dtype, int64_t n, const void* z_out, const void* v_out,
                const void* u1, const void* h, int64_t row, double eta,
                void* z_in, void* v_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_inverse, n, z_out, v_out, u1, h, row, eta, z_in,
           v_in, s)
}

int alf_inverse_update(int dtype, int64_t n, const void* k1,
                       const void* v_out, const void* u1, const void* h,
                       int64_t row, double eta, void* z_in, void* v_in,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_inverse_update, n, k1, v_out, u1, h, row, eta, z_in,
           v_in, s)
}

int alf_midpoint_vjp(int dtype, int64_t n, const void* g, const void* h,
                     int64_t row, double sign, void* v_bar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_midpoint_vjp, n, g, h, row, sign, v_bar, s)
}

int alf_update_vjp(int dtype, int64_t n, const void* g_z, const void* g_v,
                   const void* h, int64_t row, double eta, void* v_bar,
                   void* u1_bar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_update_vjp, n, g_z, g_v, h, row, eta, v_bar,
           u1_bar, s)
}

}  // extern "C"
