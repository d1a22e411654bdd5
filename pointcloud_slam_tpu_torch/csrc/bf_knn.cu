// Exact brute-force k-nearest-neighbour search on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pointcloud_slam_tpu/ops/pallas/bf_knn.py:
//   * K1 `_knn_kernel` (wrapper `knn`, pallas_call at :115), entry `pcs_bf_knn`;
//   * K2 `_nn_kernel` (wrapper `nearest_neighbor`, pallas_call at :162), entry
//     `pcs_bf_nn`: the K = 1 instance of the same kernel. With K = 1 the
//     insertion loop is empty and what remains is `_nn_kernel`'s running min
//     and argmin; the strict `<` over tiles walked in ascending index order
//     keeps the lower index on ties, as `_nn_kernel`'s `tile_min < best` does.
// It computes what those kernels compute — for each query the k database
// points of least squared distance, ascending — but is not carried over
// block by block:
//
//   * One query per thread. A block stages database tiles of kTile points
//     (structure of arrays, f32) in shared memory and every thread walks the
//     whole tile; a loop over tiles inside the block takes the place of the
//     TPU grid's sequential database axis.
//   * The running top-k lives in registers as explicit (d2, idx) pairs, with
//     k a template parameter (instantiated for 1, 5, 8, 20). A candidate is
//     inserted behind every entry it does not strictly beat, and tiles are
//     walked in ascending index order, so among equal distances the lower
//     index stays first. The TPU kernel's mantissa index packing is dropped.
//   * d2 is the direct difference (q-p).(q-p) in FP32 FMA. No tensor cores,
//     no TF32: the inner dimension is 3, and TF32 would reorder near-ties.
//   * Ragged N and M are masked here; there is no tile-multiple padding rule.
//     Points the caller moved far away (pad_cloud's 1e17 convention) are
//     ordinary, far, candidates.
//
// What bounds it on an H100: arithmetic, not bytes. For N = M = 50k it is
// ~2.5e9 pair evaluations, each a few FP32 FMAs plus the insertion compares;
// the database tile is read from shared memory as a broadcast. With one query
// per thread a 6k-point scan fills only ~48 blocks of 128 threads on 132 SMs;
// splitting M across blocks with a merge pass is left for later work.
//
// Plain C interface, launched on the caller's stream; the wrapper
// (ops/bf_knn.py) allocates the outputs and checks the returned
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr float kInf = 3.0e38f;

template <int K>
__global__ void __launch_bounds__(kThreads)
bf_knn_kernel(const float* __restrict__ q, int n,
              const float* __restrict__ db, int m,
              float* __restrict__ out_d2, int* __restrict__ out_idx) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float qx = live ? q[i] : 0.f;
  const float qy = live ? q[n + i] : 0.f;
  const float qz = live ? q[2 * n + i] : 0.f;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kInf;
    bi[s] = -1;
  }

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int len = min(kTile, m - t0);
    for (int j = threadIdx.x; j < len; j += kThreads) {
      sx[j] = db[t0 + j];
      sy[j] = db[m + t0 + j];
      sz[j] = db[2 * m + t0 + j];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < len; ++j) {
        const float dx = qx - sx[j];
        const float dy = qy - sy[j];
        const float dz = qz - sz[j];
        const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        if (d < bd[K - 1]) {
          const int c = t0 + j;
          // shift every entry that d strictly beats one place down, then
          // drop d into the gap (top-down so bd[s - 1] is still the old value)
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            const bool shift = d < bd[s - 1];
            const bool here = !shift && d < bd[s];
            bd[s] = shift ? bd[s - 1] : (here ? d : bd[s]);
            bi[s] = shift ? bi[s - 1] : (here ? c : bi[s]);
          }
          if (d < bd[0]) {
            bd[0] = d;
            bi[0] = c;
          }
        }
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d2[s * n + i] = bd[s];
      out_idx[s * n + i] = bi[s];
    }
  }
}

template <int K>
cudaError_t launch(const float* q, int n, const float* db, int m, float* d2, int* idx, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  bf_knn_kernel<K><<<blocks, kThreads, 0, stream>>>(q, n, db, m, d2, idx);
  return cudaGetLastError();
}

}  // namespace

// queries (3, n) and database (3, m): contiguous f32, coordinate-major.
// Outputs d2 (k, n) f32 ascending and idx (k, n) int32; -1 / 3e38 where the
// database holds fewer than k points. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a k without an instance.
extern "C" int pcs_bf_knn(const float* q, int n, const float* db, int m, int k,
                          float* d2, int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (k) {
    case 1: return launch<1>(q, n, db, m, d2, idx, s);
    case 5: return launch<5>(q, n, db, m, d2, idx, s);
    case 8: return launch<8>(q, n, db, m, d2, idx, s);
    case 20: return launch<20>(q, n, db, m, d2, idx, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Exact 1-NN (K2): queries (3, n), database (3, m) as above. Outputs d2 (n,)
// f32 and idx (n,) int32 — the (1, n) rows of the K = 1 instance, written
// flat; 3e38 / -1 where the database is empty. Returns a cudaError_t.
extern "C" int pcs_bf_nn(const float* q, int n, const float* db, int m,
                         float* d2, int* idx, void* stream) {
  if (n <= 0) return 0;
  return launch<1>(q, n, db, m, d2, idx, static_cast<cudaStream_t>(stream));
}
