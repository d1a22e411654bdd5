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
// What bounds it on an H100: the latency of its chain of dependent steps,
// not bytes or FP32 operations. A call's batch is 1 (scan-to-map, NDT) to a
// few dozen matrices (the solver's batched frames): a 6 x 6 is 144 bytes and
// its sweeps ~10^4 operations, far below a microsecond of the card's rates,
// and one thread walks them in order, each operation waiting for the one
// before it. tools/eigh_bits_torch.py measures the kernel's device time (a
// CUDA graph of 100 launches) apart from the wrapper's host time, and both
// for the same path at n = 1; PERF.md §6 has the numbers. So the design
// shortens the chain:
//
//   * Parallel (round-robin) order. A sweep is n - 1 steps for even n, n for
//     odd n (the pair with the padding label n is a bye), each of n / 2
//     disjoint pairs (kSchedule, the circle method; every pair once a
//     sweep). All angles of a step come from the matrix as the step finds
//     it, and its rotations act on disjoint planes, so they are independent:
//     a 6 x 6 sweep is a chain of 5 steps of 3 side-by-side rotations where
//     the cyclic order was a chain of 15.
//   * Turned labels. The kernel always rotates step 0's pairs, then permutes
//     A and V's columns so that the next step's pairs sit there (`turn`).
//     One step's code, run in a loop, stays in the instruction cache; the
//     sweep unrolled step by step was more code, and slower (PERF.md §6).
//   * Algebraic rotations (Rutishauser; Golub & Van Loan, sym.schur2)
//     instead of atan2 + sincos: tau = (a_qq - a_pp) / (2 a_pq),
//     t = sign(tau) / (|tau| + sqrt(1 + tau^2)) (1 / (2 tau) above TauBig,
//     where tau^2 could overflow), c = 1 / sqrt(1 + t^2), s = t c; then
//     a_pp -= t a_pq, a_qq += t a_pq, a_pq = 0. The smaller rotation,
//     |theta| <= pi / 4. Where a_pq is exactly 0, t = 0 and the rotation is
//     the identity, so exactly diagonal input comes out exactly.
//   * A fast path for the angles with no branch: the card's float
//     reciprocal and reciprocal square root (one MUFU instruction each)
//     refined by Newton steps to about one ulp. IEEE division and square
//     root carry a branch to a slow path each, which splits the code, so the
//     three angles of a step did not overlap. Where an input leaves the
//     approximations' range (an a_pq below 2^-120 or above 2^120, |tau|
//     above 2^119, a NaN), the step takes IEEE division and square root
//     instead (`exact_angle`, what the mirror computes).
//   * One thread a matrix: the upper triangle of A (n (n + 1) / 2 values)
//     and V (n x n) live in registers; n and the pairs are template
//     constants, so every index is a constant. A warp a matrix would spread
//     the rotations' updates over lanes but add dependent shuffles to each
//     step, whose chain is the angles' MUFU latency either way; shared
//     memory, TMA and wgmma have nothing to act on at a few hundred bytes.
//   * Sweeps stop when every off-diagonal |a_pq| is at most eps times the
//     largest |a_ii| (eps = the type's machine epsilon), or after
//     kMaxSweeps. The stop depends on the data inside the kernel only; a
//     NaN never stops it early.
//   * A stable ascending insertion sort of the diagonal carries V's columns.
//
// ops/small_eigh.py::eigh_jacobi_mirror repeats these sweeps in plain
// PyTorch for the CPU tests, and ops/small_eigh.py::jacobi_schedule is the
// same order as kSchedule (a CPU test holds them equal). Plain C interface,
// launched on the caller's stream; the wrapper allocates the outputs and
// checks the returned cudaGetLastError(). Built with -DPCS_COUNTERS, the
// kernel also records each matrix's sweeps (pcs_small_eigh_sweeps).

#include <cuda_runtime.h>

#include <cfloat>
#include <utility>

namespace {

constexpr int kMaxN = 8;
constexpr int kMaxSweeps = 16;
constexpr int kThreads = 64;
constexpr int kMaxSteps = 7;
constexpr int kMaxPairs = 4;

// kSchedule[n - 1][step][k] = {p, q}: the pairs of each step of a sweep in
// the matrix's own labels, in the order and orientation they are rotated;
// unused entries are zero. The kernel rotates the pairs of step 0 on a
// relabeled matrix (below); schedule_turns() checks that the later steps
// are those pairs under the turned labels.
constexpr int kSchedule[kMaxN][kMaxSteps][kMaxPairs][2] = {
    /* n = 1 */ {{}},
    /* n = 2 */ {{{0, 1}}},
    /* n = 3 */ {{{1, 2}}, {{2, 0}}, {{0, 1}}},
    /* n = 4 */ {{{0, 3}, {1, 2}}, {{1, 3}, {2, 0}}, {{2, 3}, {0, 1}}},
    /* n = 5 */ {{{1, 4}, {2, 3}}, {{2, 0}, {3, 4}}, {{3, 1}, {4, 0}}, {{4, 2}, {0, 1}}, {{0, 3}, {1, 2}}},
    /* n = 6 */ {{{0, 5}, {1, 4}, {2, 3}}, {{1, 5}, {2, 0}, {3, 4}}, {{2, 5}, {3, 1}, {4, 0}},
                 {{3, 5}, {4, 2}, {0, 1}}, {{4, 5}, {0, 3}, {1, 2}}},
    /* n = 7 */ {{{1, 6}, {2, 5}, {3, 4}}, {{2, 0}, {3, 6}, {4, 5}}, {{3, 1}, {4, 0}, {5, 6}},
                 {{4, 2}, {5, 1}, {6, 0}}, {{5, 3}, {6, 2}, {0, 1}}, {{6, 4}, {0, 3}, {1, 2}},
                 {{0, 5}, {1, 4}, {2, 3}}},
    /* n = 8 */ {{{0, 7}, {1, 6}, {2, 5}, {3, 4}}, {{1, 7}, {2, 0}, {3, 6}, {4, 5}},
                 {{2, 7}, {3, 1}, {4, 0}, {5, 6}}, {{3, 7}, {4, 2}, {5, 1}, {6, 0}},
                 {{4, 7}, {5, 3}, {6, 2}, {0, 1}}, {{5, 7}, {6, 4}, {0, 3}, {1, 2}},
                 {{6, 7}, {0, 5}, {1, 4}, {2, 3}}},
};

template <int N> constexpr int kSteps = N % 2 ? N : N - 1;   // also the number of labels that turn
template <int N> constexpr int kPairs = N / 2;
template <int N> constexpr int kTri = N * (N + 1) / 2;
template <int N, int K> constexpr int kP = kSchedule[N - 1][0][K][0];
template <int N, int K> constexpr int kQ = kSchedule[N - 1][0][K][1];

// The label a position holds after one more step: labels 0..L-1 turn by one
// (L = kSteps), label L (the fixed one of even n) stays.
template <int N>
__host__ __device__ constexpr int turned(int i) {
  return i < kSteps<N> ? (i + 1) % kSteps<N> : i;
}

// Step s of kSchedule is step 0 with every label i < L moved to (i + s) mod L.
template <int N>
constexpr bool schedule_turns() {
  for (int s = 0; s < kSteps<N>; ++s) {
    for (int k = 0; k < kPairs<N>; ++k) {
      for (int e = 0; e < 2; ++e) {
        const int i = kSchedule[N - 1][0][k][e];
        if (kSchedule[N - 1][s][k][e] != (i < kSteps<N> ? (i + s) % kSteps<N> : i)) return false;
      }
    }
  }
  return true;
}
static_assert(schedule_turns<1>() && schedule_turns<2>() && schedule_turns<3>() && schedule_turns<4>() &&
                  schedule_turns<5>() && schedule_turns<6>() && schedule_turns<7>() && schedule_turns<8>(),
              "kSchedule is not the turned circle");

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr float value = FLT_EPSILON; };
template <> struct Eps<double> { static constexpr double value = DBL_EPSILON; };
// Above TauBig, tau^2 could overflow; there t = 1 / (2 tau) to the type's precision.
template <typename T> struct TauBig;
template <> struct TauBig<float> { static constexpr float value = 0x1p60f; };
template <> struct TauBig<double> { static constexpr double value = 0x1p500; };

// The step's fast path holds where every pair has a_pq = 0 or 2^-120 <= |a_pq|
// <= 2^120 and |tau| <= 2^119: there the float approximations below see
// normal inputs and results. Above kFastTau = 2^60 it takes t = 1 / (2 tau),
// as the IEEE path does above TauBig (in double both agree to rounding:
// sqrt(1 + tau^2) rounds to |tau| beyond 2^27).
constexpr float kFastMin = 0x1p-120f, kFastMax = 0x1p120f, kFastTau = 0x1p60f, kFastTauMax = 0x1p119f;
// Newton steps after the float approximation: its ~2^-22 error becomes one
// ulp of the type's.
template <typename T> constexpr int kNewton = sizeof(T) == 4 ? 1 : 2;

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }
__device__ __forceinline__ float with_sign(float x, float y) { return copysignf(x, y); }
__device__ __forceinline__ double with_sign(double x, double y) { return copysign(x, y); }
__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

// 1 / x: the card's approximate float reciprocal (__fdividef, ~2 ulp, one
// MUFU instruction, no branch) refined by Newton steps r (2 - x r).
template <typename T>
__device__ __forceinline__ T recip(T x) {
  T r = T(__fdividef(1.0f, float(x)));
#pragma unroll
  for (int i = 0; i < kNewton<T>; ++i) r = mul_add(r, mul_add(-x, r, T(1)), r);
  return r;
}

// 1 / sqrt(x): rsqrtf (~2 ulp) refined by Newton steps y (3 - x y^2) / 2.
template <typename T>
__device__ __forceinline__ T recip_root(T x) {
  T y = T(rsqrtf(float(x)));
#pragma unroll
  for (int i = 0; i < kNewton<T>; ++i) y = mul_add(T(0.5) * y, mul_add(-x * y, y, T(1)), y);
  return y;
}

// The rotation of (a_pp, a_qq, a_pq) by IEEE division and square root, as
// ops/small_eigh.py::eigh_jacobi_mirror computes it.
template <typename T>
__device__ __forceinline__ void exact_angle(T app, T aqq, T apq, T& t, T& c, T& s) {
  const T tau = (aqq - app) / (T(2) * apq);
  const T at = magnitude(tau);
  t = with_sign(T(1) / (at > TauBig<T>::value ? T(2) * at : at + root(T(1) + tau * tau)), tau);
  t = apq == T(0) ? T(0) : t;
  c = T(1) / root(T(1) + t * t);
  s = t * c;
}

// The same rotation on the fast path: no branch, so the compiler interleaves
// the angles of a step's pairs. Each division and square root is a refined
// approximation (one ulp, not always the IEEE rounding). Returns whether
// the fast path holds for this pair.
template <typename T>
__device__ __forceinline__ bool fast_angle(T app, T aqq, T apq, T& t, T& c, T& s) {
  const T den = T(2) * apq, d = aqq - app;
  const T rd = recip(den);
  const T q = d * rd;
  const T tau = mul_add(rd, mul_add(-den, q, d), q);   // d / den, corrected once
  const T at = magnitude(tau);
  const T x = mul_add(tau, tau, T(1));
  const T y = recip_root(x);
  const T r0 = x * y;
  const T r = mul_add(T(0.5) * y, mul_add(-r0, r0, x), r0);   // sqrt(1 + tau^2), corrected once
  t = with_sign(recip(at > T(kFastTau) ? T(2) * at : at + r), tau);
  c = recip_root(mul_add(t, t, T(1)));
  s = t * c;
  const bool zero = apq == T(0);
  t = zero ? T(0) : t;
  c = zero ? T(1) : c;
  s = zero ? T(0) : s;
  const T m = magnitude(apq);
  return zero || (m >= T(kFastMin) && m <= T(kFastMax) && at <= T(kFastTauMax));
}

#ifdef PCS_COUNTERS
constexpr int kCounted = 1 << 16;
__device__ int g_sweeps[kCounted];   // sweeps of matrix b < kCounted in the last launch
#endif

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

// The stop test: every off-diagonal |a_ij| at most eps times the largest
// |a_ii|. It also ends a zero matrix; a NaN never ends the sweeps early.
template <typename T, int N>
__device__ __forceinline__ bool converged(const T (&a)[kTri<N>]) {
  T off = T(0), diag = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    diag = worse(diag, a[tri<N>(i, i)]);
#pragma unroll
    for (int j = i + 1; j < N; ++j) off = worse(off, a[tri<N>(i, j)]);
  }
  return off <= Eps<T>::value * diag;
}

// The rotation of pair K, with its t, c, s: rows and columns p, q of A
// (J^T A J) and columns p, q of V (V J).
template <typename T, int N, bool kVectors, int K>
__device__ __forceinline__ void rotate(T (&a)[kTri<N>], T (&v)[N][N], T t, T c, T s) {
  constexpr int p = kP<N, K>, q = kQ<N, K>;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r == p || r == q) continue;
    const T arp = a[at<N>(r, p)], arq = a[at<N>(r, q)];
    a[at<N>(r, p)] = c * arp - s * arq;
    a[at<N>(r, q)] = s * arp + c * arq;
  }
  const T apq = a[tri<N>(p, q)];
  a[tri<N>(p, p)] = a[tri<N>(p, p)] - t * apq;
  a[tri<N>(q, q)] = a[tri<N>(q, q)] + t * apq;
  a[tri<N>(p, q)] = T(0);
  if constexpr (kVectors) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const T vp = v[r][p], vq = v[r][q];
      v[r][p] = c * vp - s * vq;
      v[r][q] = s * vp + c * vq;
    }
  }
}

// One step: the angles of the step's pairs on the fast path (or, where it
// does not hold for a pair, all of them by IEEE arithmetic), then the
// rotations in the table's order.
template <typename T, int N, bool kVectors, int... K>
__device__ __forceinline__ void step(T (&a)[kTri<N>], T (&v)[N][N], std::integer_sequence<int, K...>) {
  constexpr int P = sizeof...(K);
  if constexpr (P > 0) {
    const T app[P] = {a[tri<N>(kP<N, K>, kP<N, K>)]...};
    const T aqq[P] = {a[tri<N>(kQ<N, K>, kQ<N, K>)]...};
    const T apq[P] = {a[at<N>(kP<N, K>, kQ<N, K>)]...};
    T t[P], c[P], s[P];
    bool fast = true;
#pragma unroll
    for (int k = 0; k < P; ++k) fast &= fast_angle(app[k], aqq[k], apq[k], t[k], c[k], s[k]);
    if (!fast) {
#pragma unroll
      for (int k = 0; k < P; ++k) exact_angle(app[k], aqq[k], apq[k], t[k], c[k], s[k]);
    }
    (rotate<T, N, kVectors, K>(a, v, t[K], c[K], s[K]), ...);
  }
}

// Turns the labels by one: A <- P^T A P and V <- V P for the permutation
// P of `turned`, so that the next step's pairs sit where step 0's were. After
// the L steps of a sweep the labels are back where they started.
template <typename T, int N, bool kVectors>
__device__ __forceinline__ void turn(T (&a)[kTri<N>], T (&v)[N][N]) {
  T b[kTri<N>];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) b[tri<N>(i, j)] = a[at<N>(turned<N>(i), turned<N>(j))];
  }
#pragma unroll
  for (int i = 0; i < kTri<N>; ++i) a[i] = b[i];
  if constexpr (kVectors) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      T row[N];
#pragma unroll
      for (int i = 0; i < N; ++i) row[i] = v[r][turned<N>(i)];
#pragma unroll
      for (int i = 0; i < N; ++i) v[r][i] = row[i];
    }
  }
}

template <typename T, int N, bool kVectors>
__global__ void __launch_bounds__(kThreads)
small_eigh_kernel(const T* __restrict__ in, int batch, T* __restrict__ w_out, T* __restrict__ v_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const T* src = in + static_cast<size_t>(b) * N * N;
  T a[kTri<N>];
  T v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) a[tri<N>(i, j)] = src[j * N + i];   // the lower triangle
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = i == j ? T(1) : T(0);
  }

  int sweeps = 0;
  for (; sweeps < kMaxSweeps; ++sweeps) {
    if (converged<T, N>(a)) break;
    // one step's code, run L times: small enough to stay in the instruction cache
#pragma unroll 1
    for (int st = 0; st < kSteps<N>; ++st) {
      step<T, N, kVectors>(a, v, std::make_integer_sequence<int, kPairs<N>>{});
      turn<T, N, kVectors>(a, v);
    }
  }
#ifdef PCS_COUNTERS
  if (b < kCounted) g_sweeps[b] = sweeps;
#endif

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

#ifdef PCS_COUNTERS
// Copies the sweeps of the first `count` matrices (count <= 65,536) of the
// last launch to `out` (host memory), after the launch has finished.
extern "C" int pcs_small_eigh_sweeps(int* out, int count) {
  if (count < 0 || count > kCounted) return cudaErrorInvalidValue;
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_sweeps, count * sizeof(int)));
}
#endif
