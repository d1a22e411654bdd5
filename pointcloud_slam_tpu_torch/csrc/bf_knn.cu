// Exact brute-force k-nearest-neighbour search on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pointcloud_slam_tpu/ops/pallas/bf_knn.py:
//   * K1 `_knn_kernel` (wrapper `knn`, pallas_call at :115), entry `pcs_bf_knn`;
//   * K2 `_nn_kernel` (wrapper `nearest_neighbor`, pallas_call at :162), entry
//     `pcs_bf_nn`: the K = 1 instance of the same search, a running min and
//     argmin with a strict `<`, written flat.
// It computes what those kernels compute — for each query the k database
// points of least squared distance, ascending, the lower index first among
// equal distances — with d2 the direct difference (q-p).(q-p) in FP32 FMA.
// No tensor cores, no TF32: the inner dimension is 3, and the expanded form
// |q|^2+|p|^2-2q.p would reorder near-ties at scene-sized coordinates.
//
// What bounds it on an H100: the instruction rate (operations), not bytes. A
// pair costs three subtractions, a multiply, two FMAs and a minimum, and the
// whole database (a few hundred KB) sits in L2. At its callers' sizes (6k-28k
// queries) there are too few queries to fill the card with one warp per 32 of
// them, and every candidate that has to enter a sorted list costs many times
// a distance. This is what answers that:
//
//   * S, the M-split. The database is cut into S contiguous ranges. The four
//     warps of a block search four ranges for the same 32 queries, the grid
//     is (query blocks, S / 4), and each warp writes a sorted partial top-k to
//     scratch (S, k, N); `merge_kernel`, one thread a query, merges the S
//     lists by (d2, idx) and writes (k, N). S is 4, 8, 12 or 16 and comes
//     from the wrapper as a function of the shapes alone. No atomics. A split
//     list starts empty, so it admits far more candidates than its share; the
//     warps of a block therefore tell each other how far their lists have
//     come and prune with the bound that follows (`share` below). The merge
//     pass is a few percent of the search at the callers' sizes.
//   * One query a thread, tiles read four points a load. A warp's tile of the
//     database is staged in shared memory, one array per coordinate, and read
//     with broadcast 128-bit loads. The sorted list lives in registers (K
//     pairs). More queries a thread would share a load among them but halve
//     the warps, and at these sizes the card is short of warps, not of loads.
//   * The queues. The search walks kStep points a step; their distances are
//     independent chains, and only their minimum is tested against the
//     threshold, by one warp vote a step. When some lane passes, the warp
//     appends what passes, point by point, to short per-query queues in shared
//     memory. When any lane's queue could overflow in the next step, the whole
//     warp drains its queues into the sorted lists together, in arrival order,
//     and refreshes the thresholds (the thread-queue scheme of GPU k-selection,
//     Johnson, Douze, Jegou, "Billion-scale similarity search with GPUs").
//     At K = 1 there is no queue: a running min and argmin.
//
// The tie rule survives all of it: ranges and tiles are walked in ascending
// index order, a candidate is inserted behind every entry it does not
// strictly beat, a queue drains in arrival order, a bound taken from another
// range admits what equals it, and the merge compares (d2, idx). A candidate
// that passed a stale threshold but not the current one falls out of the
// insertion unchanged.
//
// K is a template parameter; a k without an instance of its own runs the next
// larger one and writes its first k rows (the wrapper names the instance).
// Ragged N and M are masked here. Points the caller moved far away
// (pad_cloud's 1e17 convention) are ordinary, far, candidates.
//
// Plain C interface, launched on the caller's stream; the wrapper
// (ops/bf_knn.py) allocates the outputs and the scratch, and checks the
// returned cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 4;         // warps a block: each searches its own range for the block's queries
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 256;       // database points a warp stages per tile (3 KB)
constexpr int kStep = 8;         // database points per step of the search (a power of two)
constexpr int kMaxSplits = 16;
constexpr int kMergeThreads = 128;
constexpr float kInf = 3.0e38f;

// Built with -DPCS_COUNTERS (tools/knn_sweep_torch.py --count), the search
// counts its steps, candidates and drains; the atomics make that build one
// for counting, not for timing.
#ifdef PCS_COUNTERS
__device__ unsigned long long g_count[8];
#define COUNT(slot, by) atomicAdd(&g_count[slot], static_cast<unsigned long long>(by))
#define COUNT_WARP(slot, by) if (lane == 0) COUNT(slot, by)
#else
#define COUNT(slot, by)
#define COUNT_WARP(slot, by)
#endif

// The least float above a non-negative x: a threshold that still admits x.
__device__ __forceinline__ float next_up(float x) { return __int_as_float(__float_as_int(x) + 1); }

// Insert (d, c) behind every entry it does not strictly beat; a d that beats
// nothing leaves the list as it was.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int c) {
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

// Block (b, g), warp w: the top-K of database range s = g * kWarps + w,
// [s * chunk, (s + 1) * chunk), for queries b * 32 ..; lane l holds query
// b * 32 + l. Writes rows 0..k_out-1 to out[(s * k_out + row) * n + i].
//
// The four warps of a block search different ranges for the same queries and
// tell each other, through shared memory, two distances of their lists so
// far: the K-th and the ceil(K / 4)-th. The final k-th distance is at most
// any warp's K-th, and at most the largest of the four ceil(K / 4)-ths (that
// many entries of each range make k together). A warp admits a candidate
// only below its own K-th distance and at or below that bound: the ranges
// prune each other, and splitting costs few extra candidates. What a warp
// reads may be stale by a step; every value ever written is a valid bound,
// so the result does not depend on the timing.
//
// The database is walked U points at a time: the U distances are independent
// chains, and only their minimum is compared with the threshold, so the
// common case costs one FMNMX a pair and one vote a step. When any lane of
// the warp has a passing minimum, the warp looks again, point by point in
// index order, and queues (K > 1) or takes (K = 1) what passes.
template <int K>
__global__ void __launch_bounds__(kThreads)
search_kernel(const float* __restrict__ q, int n, const float* __restrict__ db, int m, int chunk, int k_out,
              float* __restrict__ out_d2, int* __restrict__ out_idx) {
  constexpr int U = kStep;
  constexpr int kQueue = U + 4;   // queue slots per query; drained when a step could overflow them
  constexpr int kSlots = K > 1 ? kQueue * kThreads : 1;
  constexpr unsigned kWarp = 0xffffffffu;
  // a tile per warp, one array per coordinate so that a 128-bit load brings
  // four points' worth of one; the last step prefetches past the tile
  __shared__ __align__(16) float tiles[kWarps][3][kTile + 2 * U];
  __shared__ float2 queue[kSlots];         // (d2, index bits), slot-major so a warp's lanes hit distinct banks
  constexpr int kShare = (K + kWarps - 1) / kWarps;   // entries of each range that make K together
  __shared__ float reached[2][kWarps][32];            // each warp's K-th and kShare-th distance so far, per query

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i = blockIdx.x * 32 + lane;
  float* const tile_x = tiles[warp][0];
  float* const tile_y = tiles[warp][1];
  float* const tile_z = tiles[warp][2];
  float bd[K];
  int bi[K];
#ifdef PCS_NO_CANDIDATES   // a timing aid of tools/knn_sweep_torch.py: distances, staging and merge alone
  const bool live = false;
#else
  const bool live = i < n;
#endif
  const float qx = live ? q[i] : 0.f;
  const float qy = live ? q[n + i] : 0.f;
  const float qz = live ? q[2 * n + i] : 0.f;
  // a query past the end never admits a candidate, so it never fills a queue
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = live ? kInf : -1.f;
    bi[s] = -1;
  }
  float thr = reached[0][warp][lane] = reached[1][warp][lane] = bd[K - 1];
  float2* const head = queue + tid;        // the query's queue is every kThreads-th slot from here
  float2* next = head;                     // where its next candidate goes
  for (int j = kTile + lane; j < kTile + 2 * U; j += 32) {
    tile_x[j] = kInf;
    tile_y[j] = tile_z[j] = 0.f;
  }
  __syncthreads();

  // Publish this warp's two distances and take the threshold: strictly below
  // the own K-th (an equal distance later in the own range has the higher
  // index), at or below the bound the four warps give together.
  auto share = [&]() {
    volatile float* const kth = &reached[0][0][lane];
    volatile float* const part = &reached[1][0][lane];
    kth[warp * 32] = bd[K - 1];
    part[warp * 32] = bd[kShare - 1];
    float least_kth = kth[0], most_part = part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      least_kth = fminf(least_kth, kth[w * 32]);
      most_part = fmaxf(most_part, part[w * 32]);
    }
    thr = fminf(bd[K - 1], next_up(fminf(least_kth, most_part)));
  };

  // One step: the U points in (px, py, pz) (database indices c0 ..) against the query.
  auto step = [&](const float (&px)[U], const float (&py)[U], const float (&pz)[U], int c0) {
    float d[U], t[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dx = qx - px[u];
      const float dy = qy - py[u];
      const float dz = qz - pz[u];
      t[u] = d[u] = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
    }
#pragma unroll
    for (int w = U / 2; w > 0; w /= 2) {
#pragma unroll
      for (int u = 0; u < w; ++u) t[u] = fminf(t[u], t[u + w]);
    }
    COUNT_WARP(0, 1);
    if (!__any_sync(kWarp, t[0] < thr)) return;
    COUNT_WARP(1, 1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (d[u] < thr) {
        if constexpr (K == 1) {
          thr = bd[0] = d[u];
          bi[0] = c0 + u;
        } else {
          *next = make_float2(d[u], __int_as_float(c0 + u));
          next += kThreads;
          COUNT(2, 1);
        }
      }
    }
    if constexpr (K > 1) {
      // the next step may add U more: drain the whole warp's queues together
      const int held = static_cast<int>(next - head) / kThreads;
      if (!__any_sync(kWarp, held > kQueue - U)) return;
      const int most = __reduce_max_sync(kWarp, held);   // the fullest lane's count
      COUNT_WARP(3, 1);
      COUNT_WARP(4, most);
      COUNT(5, held);
      for (int s = 0; s < most; ++s) {
        if (s < held) {
          const float2 e = head[s * kThreads];
          insert<K>(bd, bi, e.x, __float_as_int(e.y));
        }
      }
      next = head;
      share();
    }
  };

  const int split = blockIdx.y * kWarps + warp;
  const int begin = min(m, split * chunk);
  const int end = min(m, begin + chunk);
  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int len = min(kTile, end - t0);
    const int padded = (len + 2 * U - 1) / (2 * U) * (2 * U);
    __syncwarp();
    // beyond len: a point whose d2 overflows to +inf, which passes no test
    for (int j = lane; j < padded; j += 32) {
      const bool in = j < len;
      tile_x[j] = in ? db[t0 + j] : kInf;
      tile_y[j] = in ? db[m + t0 + j] : 0.f;
      tile_z[j] = in ? db[2 * m + t0 + j] : 0.f;
    }
    __syncwarp();
    share();
    // two steps an iteration, each loading the next step's points before it
    // tests its own, so the loads overlap the vote
    float ax[U], ay[U], az[U], bx[U], by[U], bz[U];
    auto load = [&](float (&px)[U], float (&py)[U], float (&pz)[U], int j) {
#pragma unroll
      for (int u = 0; u < U; u += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&tile_x[j + u]);
        const float4 y = *reinterpret_cast<const float4*>(&tile_y[j + u]);
        const float4 z = *reinterpret_cast<const float4*>(&tile_z[j + u]);
        px[u] = x.x, px[u + 1] = x.y, px[u + 2] = x.z, px[u + 3] = x.w;
        py[u] = y.x, py[u + 1] = y.y, py[u + 2] = y.z, py[u + 3] = y.w;
        pz[u] = z.x, pz[u + 1] = z.y, pz[u + 2] = z.z, pz[u + 3] = z.w;
      }
    };
    load(ax, ay, az, 0);
    for (int j0 = 0; j0 < padded; j0 += 2 * U) {
      load(bx, by, bz, j0 + U);
      step(ax, ay, az, t0 + j0);
      load(ax, ay, az, j0 + 2 * U);
      step(bx, by, bz, t0 + j0 + U);
    }
  }

  if constexpr (K > 1) {
    for (const float2* e = head; e < next; e += kThreads) insert<K>(bd, bi, e->x, __float_as_int(e->y));
  }
  if (i < n) {
    const size_t base = static_cast<size_t>(split) * k_out * n + i;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k_out) {
        out_d2[base + static_cast<size_t>(s) * n] = bd[s];
        out_idx[base + static_cast<size_t>(s) * n] = bi[s];
      }
    }
  }
}

// One thread a query: merges the S sorted lists part[(s * k + row) * n + i]
// by (d2, idx) into out[row * n + i]. Splits hold ascending index ranges, so
// the lexicographic order is the single search's order.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_d2, const int* __restrict__ part_idx, int n, int k, int splits,
             float* __restrict__ out_d2, int* __restrict__ out_idx) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(n);
  float hd[kMaxSplits];
  int hi[kMaxSplits];
  int pos[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    const bool used = s < splits;
    pos[s] = 0;
    hd[s] = used ? part_d2[static_cast<size_t>(s) * k * row + i] : INFINITY;   // an exhausted list: after every entry
    hi[s] = used ? part_idx[static_cast<size_t>(s) * k * row + i] : INT_MAX;
  }
  for (int o = 0; o < k; ++o) {
    int best = 0;
    float d = hd[0];
    int c = hi[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s) {
      if (hd[s] < d || (hd[s] == d && hi[s] < c)) {
        best = s;
        d = hd[s];
        c = hi[s];
      }
    }
    out_d2[o * row + i] = d;
    out_idx[o * row + i] = c;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s == best) {
        const bool more = ++pos[s] < k;
        const size_t at = (static_cast<size_t>(s) * k + (more ? pos[s] : 0)) * row + i;
        hd[s] = more ? part_d2[at] : INFINITY;
        hi[s] = more ? part_idx[at] : INT_MAX;
      }
    }
  }
}

struct Args {
  const float* q;
  int n;
  const float* db;
  int m;
  int k;            // rows written
  int splits;
  float* d2;        // (k, n)
  int* idx;
  float* part_d2;   // (splits, k, n) scratch
  int* part_idx;
  cudaStream_t stream;
};

template <int K>
cudaError_t launch(const Args& a) {
  const int chunk = (a.m + a.splits - 1) / a.splits;
  const dim3 grid((a.n + 31) / 32, a.splits / kWarps);
  search_kernel<K><<<grid, kThreads, 0, a.stream>>>(a.q, a.n, a.db, a.m, chunk, a.k, a.part_d2, a.part_idx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<(a.n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, a.stream>>>(
      a.part_d2, a.part_idx, a.n, a.k, a.splits, a.d2, a.idx);
  return cudaGetLastError();
}

cudaError_t dispatch(int instance, const Args& a) {
  if (a.n <= 0) return cudaSuccess;
  if (a.k < 1 || a.k > instance || a.splits < kWarps || a.splits > kMaxSplits || a.splits % kWarps) {
    return cudaErrorInvalidValue;
  }
  switch (instance) {
    case 1: return launch<1>(a);
    case 2: return launch<2>(a);
    case 4: return launch<4>(a);
    case 8: return launch<8>(a);
    case 12: return launch<12>(a);
    case 16: return launch<16>(a);
    case 20: return launch<20>(a);
    case 24: return launch<24>(a);
    case 32: return launch<32>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// queries (3, n) and database (3, m): contiguous f32, coordinate-major.
// Outputs d2 (k, n) f32 ascending and idx (k, n) int32; -1 / 3e38 where the
// database holds fewer than k points. `instance` >= k is the list length the
// search runs with, `splits` the number of database ranges (4, 8, 12 or 16);
// part_d2 / part_idx are (splits, k, n) scratch. Returns a cudaError_t (0 =
// both passes launched); cudaErrorInvalidValue for an (instance, splits) that
// was not built.
extern "C" int pcs_bf_knn(const float* q, int n, const float* db, int m, int k, int instance, int splits, float* d2,
                          int* idx, float* part_d2, int* part_idx, void* stream) {
  return static_cast<int>(
      dispatch(instance, Args{q, n, db, m, k, splits, d2, idx, part_d2, part_idx, static_cast<cudaStream_t>(stream)}));
}

// Exact 1-NN (K2): queries (3, n), database (3, m) as above. Outputs d2 (n,)
// f32 and idx (n,) int32 — the (1, n) rows of the K = 1 instance, written
// flat; 3e38 / -1 where the database is empty. part_d2 / part_idx are
// (splits, n) scratch. Returns a cudaError_t.
extern "C" int pcs_bf_nn(const float* q, int n, const float* db, int m, int splits, float* d2, int* idx,
                         float* part_d2, int* part_idx, void* stream) {
  return static_cast<int>(
      dispatch(1, Args{q, n, db, m, 1, splits, d2, idx, part_d2, part_idx, static_cast<cudaStream_t>(stream)}));
}

#ifdef PCS_COUNTERS
// Copies the eight counters to `out` (host memory), or sets them to 0 when `reset`.
extern "C" int pcs_counts(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_count, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_count, 8 * sizeof(unsigned long long)));
}
#endif
