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
// 0.78 us at 2048 x 64 and 80 / 160 / 200 / 200 us at 2^25.
//
// Design against that bound: one pass over one flat contiguous buffer
// (the op layer packs the whole state pytree into it), each input read
// once and each output written once, coalesced (neighbouring threads on
// neighbouring elements), with a grid-stride loop and a masked tail. The
// TPU's [rows, 128] lane layout and its padding to a block multiple are
// not carried over. alf_midpoint_vjp, a scaled copy with a single input,
// moves 16-byte vectors instead (4 float, 8 bfloat16 or 2 double), up to
// four in flight per thread, on a grid of at most 8 blocks per SM; the elements before
// the output's first 16-byte boundary and after its last whole vector go
// one by one, and an input at another offset from a 16-byte boundary than
// the output is read element by element (nothing is copied to align it).
// The step size h is read through a device pointer, so
// an adaptive controller that computes h on the card never syncs the
// host. Nothing is allocated here; launches go on the caller's stream and
// return cudaGetLastError().
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

// The vectorised kernel's grid: a few blocks per SM, grid-stride beyond.
constexpr int kVecUnroll = 4;      // 16-byte vectors in flight per thread
constexpr int kVecBlocksPerSm = 8;

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

#define GRID_STRIDE(i, n)                                                  \
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < (n); \
       i += int64_t(gridDim.x) * blockDim.x)

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

// k1 = z + sign * v * (h/2)
template <typename T>
__global__ void midpoint_kernel(int64_t n, const T* __restrict__ z,
                                const T* __restrict__ v,
                                const typename Acc<T>::type* __restrict__ h,
                                double sign, T* __restrict__ k1) {
  typedef typename Acc<T>::type A;
  const A hh = *h * A(0.5);
  const A s = static_cast<A>(sign);
  GRID_STRIDE(i, n) {
    const A sv = s * ld(v, i);
    st(k1, i, ld(z, i) + sv * hh);
  }
}

// v_out = v + 2*eta*(u1 - v);  z_out = k1 + v_out * (h/2)
template <typename T>
__global__ void update_kernel(int64_t n, const T* __restrict__ k1,
                              const T* __restrict__ v,
                              const T* __restrict__ u1,
                              const typename Acc<T>::type* __restrict__ h,
                              double eta, T* __restrict__ z_out,
                              T* __restrict__ v_out) {
  typedef typename Acc<T>::type A;
  const A hh = *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  GRID_STRIDE(i, n) {
    const A vi = ld(v, i);
    const A du = ld(u1, i) - vi;
    const A vo = vi + two_eta * du;
    st(v_out, i, vo);
    st(z_out, i, ld(k1, i) + vo * hh);
  }
}

// k1 = z - v * (h/2);  cot_u1 = 2*eta * (a_v + a_z * (h/2))
template <typename T>
__global__ void bwd_pre_kernel(int64_t n, const T* __restrict__ z,
                               const T* __restrict__ v,
                               const T* __restrict__ a_z,
                               const T* __restrict__ a_v,
                               const typename Acc<T>::type* __restrict__ h,
                               double eta, T* __restrict__ k1,
                               T* __restrict__ cot_u1) {
  typedef typename Acc<T>::type A;
  const A hh = *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  GRID_STRIDE(i, n) {
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
template <typename T>
__global__ void bwd_post_kernel(int64_t n, const T* __restrict__ k1,
                                const T* __restrict__ v_out,
                                const T* __restrict__ u1,
                                const T* __restrict__ a_z,
                                const T* __restrict__ a_v,
                                const T* __restrict__ dk1,
                                const typename Acc<T>::type* __restrict__ h,
                                double eta, int exact,
                                T* __restrict__ z_prev, T* __restrict__ v_prev,
                                T* __restrict__ dz, T* __restrict__ dv) {
  typedef typename Acc<T>::type A;
  const A hh = *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  const A one_m = static_cast<A>(1.0 - 2.0 * eta);
  GRID_STRIDE(i, n) {
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
template <typename T>
__global__ void inverse_update_kernel(int64_t n, const T* __restrict__ k1,
                                      const T* __restrict__ v_out,
                                      const T* __restrict__ u1,
                                      const typename Acc<T>::type* __restrict__ h,
                                      double eta, int exact,
                                      T* __restrict__ z_in,
                                      T* __restrict__ v_in) {
  typedef typename Acc<T>::type A;
  const A hh = *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  const A one_m = static_cast<A>(1.0 - 2.0 * eta);
  GRID_STRIDE(i, n) {
    const A vi = inverse_velocity(ld(v_out, i), ld(u1, i), two_eta, one_m,
                                  exact);
    st(v_in, i, vi);
    const A vih = vi * hh;
    st(z_in, i, ld(k1, i) - vih);
  }
}

// k1 = z_out - v_out * (h/2);  v_in = inverse_velocity(v_out, u1);
// z_in = k1 - v_in * (h/2)
template <typename T>
__global__ void inverse_kernel(int64_t n, const T* __restrict__ z_out,
                               const T* __restrict__ v_out,
                               const T* __restrict__ u1,
                               const typename Acc<T>::type* __restrict__ h,
                               double eta, int exact, T* __restrict__ z_in,
                               T* __restrict__ v_in) {
  typedef typename Acc<T>::type A;
  const A hh = *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  const A one_m = static_cast<A>(1.0 - 2.0 * eta);
  GRID_STRIDE(i, n) {
    const A vo = ld(v_out, i);
    const A voh = vo * hh;
    const A k = ld(z_out, i) - voh;
    const A vi = inverse_velocity(vo, ld(u1, i), two_eta, one_m, exact);
    st(v_in, i, vi);
    const A vih = vi * hh;
    st(z_in, i, k - vih);
  }
}

// v_bar = sign * g * (h/2), by 16-byte vectors of V elements: v_bar's
// first `head` elements (up to its first 16-byte boundary) and its last
// (n - head) % V are written one by one, by the grid's first threads; the
// vectors between go through a grid-stride loop, one vector per thread on
// a small buffer and kVecUnroll in flight per thread once the grid is
// capped at kVecBlocksPerSm blocks per SM. g is read by vectors when it
// sits at v_bar's offset from a 16-byte boundary (kVecIn), else element by
// element.
template <typename T, bool kVecIn>
__global__ void __launch_bounds__(kThreads)
    midpoint_vjp_kernel(int64_t n, int64_t head, const T* __restrict__ g,
                        const typename Acc<T>::type* __restrict__ h,
                        double sign, T* __restrict__ v_bar) {
  typedef typename Acc<T>::type A;
  constexpr int V = 16 / sizeof(T);
  const A hh = *h * A(0.5);
  const A s = static_cast<A>(sign);
  const int64_t nv = (n - head) / V;
  const int64_t body_end = head + nv * V;
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t edge = t < head ? t : body_end + (t - head);
  if (edge < n && (t < head || edge >= body_end)) {
    const A sg = s * ld(g, edge);
    st(v_bar, edge, sg * hh);
  }
  const T* gv = g + head;
  T* ov = v_bar + head;
  const int64_t threads = int64_t(gridDim.x) * blockDim.x;
  for (int64_t j0 = t; j0 < nv; j0 += threads * kVecUnroll) {
    uint4 x[kVecUnroll];
#pragma unroll
    for (int k = 0; k < kVecUnroll; ++k) {
      const int64_t j = j0 + k * threads;
      if (j < nv) {
        if (kVecIn) {
          x[k] = reinterpret_cast<const uint4*>(gv)[j];
        } else {
          T* e = reinterpret_cast<T*>(&x[k]);
#pragma unroll
          for (int c = 0; c < V; ++c) e[c] = gv[j * V + c];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kVecUnroll; ++k) {
      const int64_t j = j0 + k * threads;
      if (j < nv) {
        T* e = reinterpret_cast<T*>(&x[k]);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const A sg = s * ld(e, c);
          st(e, c, sg * hh);
        }
        reinterpret_cast<uint4*>(ov)[j] = x[k];
      }
    }
  }
}

// c = g_v + g_z * (h/2);  v_bar = (1 - 2*eta) * c;  u1_bar = 2*eta * c
template <typename T>
__global__ void update_vjp_kernel(int64_t n, const T* __restrict__ g_z,
                                  const T* __restrict__ g_v,
                                  const typename Acc<T>::type* __restrict__ h,
                                  double eta, T* __restrict__ v_bar,
                                  T* __restrict__ u1_bar) {
  typedef typename Acc<T>::type A;
  const A hh = *h * A(0.5);
  const A two_eta = static_cast<A>(2.0 * eta);
  const A one_m = static_cast<A>(1.0 - 2.0 * eta);
  GRID_STRIDE(i, n) {
    const A gzh = ld(g_z, i) * hh;
    const A c = ld(g_v, i) + gzh;
    st(v_bar, i, one_m * c);
    st(u1_bar, i, two_eta * c);
  }
}

template <typename T>
int launch_midpoint(int64_t n, const void* z, const void* v, const void* h,
                    double sign, void* k1, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  midpoint_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
      n, static_cast<const T*>(z), static_cast<const T*>(v),
      static_cast<const A*>(h), sign, static_cast<T*>(k1));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_update(int64_t n, const void* k1, const void* v, const void* u1,
                  const void* h, double eta, void* z_out, void* v_out,
                  cudaStream_t s) {
  typedef typename Acc<T>::type A;
  update_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
      n, static_cast<const T*>(k1), static_cast<const T*>(v),
      static_cast<const T*>(u1), static_cast<const A*>(h), eta,
      static_cast<T*>(z_out), static_cast<T*>(v_out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_pre(int64_t n, const void* z, const void* v, const void* a_z,
                   const void* a_v, const void* h, double eta, void* k1,
                   void* cot_u1, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  bwd_pre_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
      n, static_cast<const T*>(z), static_cast<const T*>(v),
      static_cast<const T*>(a_z), static_cast<const T*>(a_v),
      static_cast<const A*>(h), eta, static_cast<T*>(k1),
      static_cast<T*>(cot_u1));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_post(int64_t n, const void* k1, const void* v_out,
                    const void* u1, const void* a_z, const void* a_v,
                    const void* dk1, const void* h, double eta, void* z_prev,
                    void* v_prev, void* dz, void* dv, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  bwd_post_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
      n, static_cast<const T*>(k1), static_cast<const T*>(v_out),
      static_cast<const T*>(u1), static_cast<const T*>(a_z),
      static_cast<const T*>(a_v), static_cast<const T*>(dk1),
      static_cast<const A*>(h), eta, eta == 1.0 ? 1 : 0,
      static_cast<T*>(z_prev), static_cast<T*>(v_prev), static_cast<T*>(dz),
      static_cast<T*>(dv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inverse(int64_t n, const void* z_out, const void* v_out,
                   const void* u1, const void* h, double eta, void* z_in,
                   void* v_in, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  inverse_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
      n, static_cast<const T*>(z_out), static_cast<const T*>(v_out),
      static_cast<const T*>(u1), static_cast<const A*>(h), eta,
      eta == 1.0 ? 1 : 0, static_cast<T*>(z_in), static_cast<T*>(v_in));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inverse_update(int64_t n, const void* k1, const void* v_out,
                          const void* u1, const void* h, double eta,
                          void* z_in, void* v_in, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  inverse_update_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
      n, static_cast<const T*>(k1), static_cast<const T*>(v_out),
      static_cast<const T*>(u1), static_cast<const A*>(h), eta,
      eta == 1.0 ? 1 : 0, static_cast<T*>(z_in), static_cast<T*>(v_in));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_midpoint_vjp(int64_t n, const void* g, const void* h, double sign,
                        void* v_bar, cudaStream_t s) {
  typedef typename Acc<T>::type A;
  constexpr int64_t V = 16 / sizeof(T);
  const uintptr_t out = reinterpret_cast<uintptr_t>(v_bar);
  const uintptr_t in = reinterpret_cast<uintptr_t>(g);
  int64_t head = int64_t((16 - (out & 15)) & 15) / int64_t(sizeof(T));
  head = head < n ? head : n;
  const int64_t nv = (n - head) / V;
  int64_t blocks = (nv + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(kVecBlocksPerSm) * sm_count();
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks > 0 ? blocks : 1;  // the edges, and one launch per call
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (((in ^ out) & 15) == 0) {
    midpoint_vjp_kernel<T, true><<<grid, kThreads, 0, s>>>(
        n, head, static_cast<const T*>(g), static_cast<const A*>(h), sign,
        static_cast<T*>(v_bar));
  } else {
    midpoint_vjp_kernel<T, false><<<grid, kThreads, 0, s>>>(
        n, head, static_cast<const T*>(g), static_cast<const A*>(h), sign,
        static_cast<T*>(v_bar));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_update_vjp(int64_t n, const void* g_z, const void* g_v,
                      const void* h, double eta, void* v_bar, void* u1_bar,
                      cudaStream_t s) {
  typedef typename Acc<T>::type A;
  update_vjp_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
      n, static_cast<const T*>(g_z), static_cast<const T*>(g_v),
      static_cast<const A*>(h), eta, static_cast<T*>(v_bar),
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

int alf_midpoint(int dtype, int64_t n, const void* z, const void* v,
                 const void* h, double sign, void* k1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_midpoint, n, z, v, h, sign, k1, s)
}

int alf_update(int dtype, int64_t n, const void* k1, const void* v,
               const void* u1, const void* h, double eta, void* z_out,
               void* v_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_update, n, k1, v, u1, h, eta, z_out, v_out, s)
}

int alf_bwd_pre(int dtype, int64_t n, const void* z, const void* v,
                const void* a_z, const void* a_v, const void* h, double eta,
                void* k1, void* cot_u1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_bwd_pre, n, z, v, a_z, a_v, h, eta, k1, cot_u1, s)
}

int alf_bwd_post(int dtype, int64_t n, const void* k1, const void* v_out,
                 const void* u1, const void* a_z, const void* a_v,
                 const void* dk1, const void* h, double eta, void* z_prev,
                 void* v_prev, void* dz, void* dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_bwd_post, n, k1, v_out, u1, a_z, a_v, dk1, h, eta,
           z_prev, v_prev, dz, dv, s)
}

int alf_inverse(int dtype, int64_t n, const void* z_out, const void* v_out,
                const void* u1, const void* h, double eta, void* z_in,
                void* v_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_inverse, n, z_out, v_out, u1, h, eta, z_in, v_in,
           s)
}

int alf_inverse_update(int dtype, int64_t n, const void* k1,
                       const void* v_out, const void* u1, const void* h,
                       double eta, void* z_in, void* v_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_inverse_update, n, k1, v_out, u1, h, eta, z_in,
           v_in, s)
}

int alf_midpoint_vjp(int dtype, int64_t n, const void* g, const void* h,
                     double sign, void* v_bar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_midpoint_vjp, n, g, h, sign, v_bar, s)
}

int alf_update_vjp(int dtype, int64_t n, const void* g_z, const void* g_v,
                   const void* h, double eta, void* v_bar, void* u1_bar,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(dtype, launch_update_vjp, n, g_z, g_v, h, eta, v_bar, u1_bar, s)
}

}  // extern "C"
