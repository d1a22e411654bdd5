// Batched eigendecomposition of small symmetric matrices on Hopper (sm_90a):
// kernel K6, entry `pcs_small_eigh`.
//
// Not a TPU kernel. It takes the place of `torch.linalg.eigh` / `eigvalsh`
// on the port's 6 x 6 normal equations (the LOAM degeneracy projector of
// register/solver.py, scan-to-map's final eigenvalues, NDT's largest
// eigenvalue), where the JAX package calls `jnp.linalg.eigh` / `eigvalsh`
// and stays on the device. PyTorch's CUDA eigh checks its `info` on the host:
// a device -> host read every call. This kernel reads nothing back.
//
// It computes, for each matrix of a batch, the eigenvalues ascending and
// (when asked) the eigenvectors as columns, from the lower triangle (as
// torch.linalg.eigh does with UPLO="L"), in float32 or float64, for any
// n <= 8.
//
// What bounds it on an H100: latency, not bytes or operations. A call's
// batch is 1 (scan-to-map, NDT) to a few dozen matrices (the solver's batched
// frames): a few hundred bytes and ~10^4-10^5 flops, far below a
// microsecond of the card's rates. The work is a chain of dependent plane
// rotations, so the design keeps it inside one thread and one launch:
//
//   * One thread a matrix. The upper triangle of A (n (n + 1) / 2 values) and
//     V (n x n) live in registers; n is a template parameter, so every index
//     is a constant.
//   * Cyclic Jacobi with the rotation of geom/fit.py::eigh_small, the angle
//     theta = 1/2 atan2(2 a_pq, a_pp - a_qq) (sincos, not the fast
//     intrinsics). A pair whose a_pq is exactly 0 is not rotated; a rotated
//     a_pq is set to 0.
//   * Sweeps stop when every off-diagonal |a_pq| is at most eps times the
//     largest |a_ii| (eps = the type's machine epsilon), or after kMaxSweeps.
//     The stop depends on the data inside the kernel only.
//   * A stable ascending insertion sort of the diagonal carries V's columns.
//
// ops/small_eigh.py::eigh_jacobi_mirror repeats these sweeps in plain
// PyTorch for the CPU tests. Plain C interface, launched on the caller's
// stream; the wrapper allocates the outputs and checks the returned
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kMaxN = 8;
constexpr int kMaxSweeps = 16;
constexpr int kThreads = 64;

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr float value = FLT_EPSILON; };
template <> struct Eps<double> { static constexpr double value = DBL_EPSILON; };

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float arc_tan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double arc_tan2(double y, double x) { return atan2(y, x); }

// The larger of acc and |x|, where a NaN wins and stays.
template <typename T>
__device__ __forceinline__ T worse(T acc, T x) {
  const T ax = x < T(0) ? -x : x;
  return (ax > acc || ax != ax) ? ax : acc;
}

// Index of (i, j), i <= j, in the packed upper triangle, row by row.
template <int N>
__host__ __device__ constexpr int tri(int i, int j) {
  return i * N - i * (i - 1) / 2 + (j - i);
}

template <int N>
__host__ __device__ constexpr int at(int i, int j) {
  return i <= j ? tri<N>(i, j) : tri<N>(j, i);
}

template <typename T, int N, bool kVectors>
__global__ void __launch_bounds__(kThreads)
small_eigh_kernel(const T* __restrict__ in, int batch, T* __restrict__ w_out, T* __restrict__ v_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const T* src = in + static_cast<size_t>(b) * N * N;
  T a[N * (N + 1) / 2];
  T v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) a[tri<N>(i, j)] = src[j * N + i];   // the lower triangle
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = i == j ? T(1) : T(0);
  }

  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    T off = T(0), diag = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      diag = worse(diag, a[tri<N>(i, i)]);
#pragma unroll
      for (int j = i + 1; j < N; ++j) off = worse(off, a[tri<N>(i, j)]);
    }
    if (off <= Eps<T>::value * diag) break;   // also ends a zero matrix; a NaN never stops early
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const T apq = a[tri<N>(p, q)];
        if (apq == T(0)) continue;
        const T app = a[tri<N>(p, p)], aqq = a[tri<N>(q, q)];
        T s, c;
        sin_cos(T(0.5) * arc_tan2(T(2) * apq, app - aqq), &s, &c);
        // columns p, q of A J (and rows p, q of J^T A J), r outside {p, q}
#pragma unroll
        for (int r = 0; r < N; ++r) {
          if (r == p || r == q) continue;
          const T arp = a[at<N>(r, p)], arq = a[at<N>(r, q)];
          a[at<N>(r, p)] = c * arp + s * arq;
          a[at<N>(r, q)] = c * arq - s * arp;
        }
        const T cc = c * c, ss = s * s, cs2 = T(2) * c * s * apq;
        a[tri<N>(p, p)] = cc * app + cs2 + ss * aqq;
        a[tri<N>(q, q)] = ss * app - cs2 + cc * aqq;
        a[tri<N>(p, q)] = T(0);
        if constexpr (kVectors) {
#pragma unroll
          for (int r = 0; r < N; ++r) {
            const T vp = v[r][p], vq = v[r][q];
            v[r][p] = c * vp + s * vq;
            v[r][q] = c * vq - s * vp;
          }
        }
      }
    }
  }

  T d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = a[tri<N>(i, i)];
  // stable: an entry moves in front of another only when strictly less
#pragma unroll
  for (int i = 1; i < N; ++i) {
#pragma unroll
    for (int j = i; j > 0; --j) {
      const bool swap = d[j] < d[j - 1];
      const T lo = swap ? d[j] : d[j - 1], hi = swap ? d[j - 1] : d[j];
      d[j - 1] = lo;
      d[j] = hi;
      if constexpr (kVectors) {
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const T x = v[r][j - 1], y = v[r][j];
          v[r][j - 1] = swap ? y : x;
          v[r][j] = swap ? x : y;
        }
      }
    }
  }
  T* w = w_out + static_cast<size_t>(b) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = d[i];
  if constexpr (kVectors) {
    T* dst = v_out + static_cast<size_t>(b) * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) dst[i * N + j] = v[i][j];
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* a, int batch, void* w, void* v, bool vectors, cudaStream_t stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  if (vectors) {
    small_eigh_kernel<T, N, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(a), batch, static_cast<T*>(w), static_cast<T*>(v));
  } else {
    small_eigh_kernel<T, N, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(a), batch, static_cast<T*>(w), nullptr);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, int batch, int n, void* w, void* v, bool vectors, cudaStream_t stream) {
  switch (n) {
    case 1: return launch<T, 1>(a, batch, w, v, vectors, stream);
    case 2: return launch<T, 2>(a, batch, w, v, vectors, stream);
    case 3: return launch<T, 3>(a, batch, w, v, vectors, stream);
    case 4: return launch<T, 4>(a, batch, w, v, vectors, stream);
    case 5: return launch<T, 5>(a, batch, w, v, vectors, stream);
    case 6: return launch<T, 6>(a, batch, w, v, vectors, stream);
    case 7: return launch<T, 7>(a, batch, w, v, vectors, stream);
    case 8: return launch<T, 8>(a, batch, w, v, vectors, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// A: (batch, n, n) contiguous, row-major, float32 (is_double = 0) or float64;
// only its lower triangle is read. Outputs w (batch, n) ascending and, when
// want_vectors, V (batch, n, n) with the eigenvectors as columns (V may be
// null otherwise). 1 <= n <= 8. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for an n outside 1..8.
extern "C" int pcs_small_eigh(const void* a, int batch, int n, void* w, void* v, int want_vectors, int is_double,
                              void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_double ? dispatch<double>(a, batch, n, w, v, want_vectors != 0, s)
                                    : dispatch<float>(a, batch, n, w, v, want_vectors != 0, s));
}
