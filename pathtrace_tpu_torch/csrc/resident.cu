// Closest hit and occlusion over the resident route's 128-row clusters, in
// one launch, with a team of threads per ray.
//
// Replaces pathtrace_tpu/ops/resident_intersect.py :: _resident_closest_kernel
// (wrapper triangle_closest_resident) and _resident_anyhit_kernel
// (triangle_anyhit_resident). Plain-torch versions in ops/intersect.py:
// triangle_closest_reference / bvh_anyhit_reference (brute force over every
// row: the hits) and resident_walk_reference (these walks step for step: the
// hits and the per-ray counts of clusters visited and rows tested).
//
// The tables are the resident route's (ops/intersect.py :: build_tables):
// the scene's triangle rows zero-padded to whole clusters of 128 rows
// (padding rows fail the |a| >= 1e-8 reject), 16 values a row, 16-byte
// aligned (a row is three Q4 loads), and one AABB row per cluster
// derived from the geometry, widened outward by a small margin so that
// slab-test rounding never drops a cluster holding a hit the twin accepts;
// padding clusters carry inverted boxes and are never entered. The entry of
// a cluster is the slab entry into [t_min, t_max] (csrc/geom.cuh ::
// box_entry: the 1e-20 guard of 1/d and the min <= max validity test, as
// _entries_block).
//
// Types. Both kernels are templates on the float type F: pt_resident_closest
// and pt_resident_anyhit are the float instances, the _f64 entry points the
// double ones (float64 rows, boxes, rays and outputs; cached entries in
// double too).
//
// A team of K threads (1, 2, 4, 8, 16 or 32, aligned in a warp; 128 threads
// a block, so 128 / K rays) shares one ray; every decision is taken on a
// team-reduced value, and every shuffle and vote names the team's own lanes
// (geom.cuh :: team_mask), as in bvh.cu and intersect.cu.
// - The closest hit walks the entered clusters nearest-first: each round the
//   team finds the cluster that follows the last visited one in ascending
//   (entry, id) order (geom.cuh :: next_box, the successor scan of bvh.cu's
//   groups and intersect.cu's clusters: thread j scans clusters j, j+K, ...,
//   then group_min), and stops when there is none or its entry is above
//   min(best_t, t_max). The gate is <=, not <: out of row order, a cluster
//   entered exactly at the current best t may hold an equal-t hit in a lower
//   row, which the brute-force twin returns.
// - The entries, once a ray: thread j computes the entries of its clusters
//   j, j+K, ... once into its own column of shared memory (ceil(C / K)
//   values of F, 128 threads a block: at K = 16 for C = 552, 17.5 KB in
//   float, 35 KB in double), and every later scan reads them back instead
//   of the boxes. Each thread reads only what it wrote, so no barrier is
//   needed, and a block's threads use neighbouring words. Where that does
//   not fit the 48 KB a block takes without an opt-in (a small K or a large
//   table: at K = 16 past 1,536 clusters, ~196k triangles, in float; past
//   768, ~98k, in double), the same kernel in its other mode (kCached =
//   false) computes the C / K entries a thread again at every scan; the
//   host picks the mode (kernels/binding.py :: resident_cached).
// - The sweep, split: thread j tests rows j, j+K, ... of the cluster
//   (Moller-Trumbore, geom.cuh :: hit_triangle: 1e-8 parallel reject,
//   inclusive barycentric bounds, closed [t_min, bound]), keeps its strict
//   first minimum of (t, row), and the team combines them as a
//   lexicographic (t, row) min (group_min); the ray's best takes it on a
//   smaller t or an equal t in a lower row. The bound tightens after each
//   cluster. So the answer equals the twin whatever K and the mode.
// - The any hit needs no order: its boolean is the same whatever clusters it
//   sweeps first. It walks the clusters in id order, K at a time: thread j
//   tests box base + j, the team ballots, and sweeps each entered cluster of
//   the K in ascending id (every kCheck rows a thread, a vote: geom.cuh ::
//   vote), stopping at the first hit, so an occluded ray tests no box past
//   its occluder's. No successor scan and no shared memory. An empty or NaN
//   range occludes nothing.
//
// What bounds it on the H100: per-ray work with divergent control flow, not
// bytes. The design before this one gave each ray one thread, which found
// the next cluster by a slab test of all C boxes at every visit (C = 552 on
// the 70k-triangle mesh: ~1,650 slab tests of ~24 flops a closest ray
// against ~240 triangle tests of ~50), and ran the union of its warp's 32
// rays' clusters. Now a closest ray pays C slab tests once, split K ways,
// then C / K shared-memory reads a scan; the sweep of its ~1.9 clusters is
// split too, and the team's shuffles are the price. The host takes K = 16
// for the closest hit and 32 for the any hit (kernels/binding.py ::
// RESIDENT_TEAM, from the times at every team in PERF.md). What is left over
// the operation bound is mostly the C box tests a ray the bound does not
// count (a hierarchy would cut them: that is the bvh route), latency and the
// scans. The boxes (17 KB) and rows (4.5 MB) stay in L1/L2: staging the boxes
// in shared memory (the design before this one) cost 0.04-0.07 ms at the
// host's teams and modes and gained at most 5% at K = 1-2 (PERF.md).
// No TMA or wgmma: the work is per-ray branching, not a product.
//
// TPU workarounds not carried over: the lane-transposed (16, T) table held
// in VMEM with its in-kernel (16, P) -> (P, 16) transposes, the (C, ray
// tile) VMEM entry scratch (65,536 x 552 x 4 B = 145 MB at this size), the
// sweep of each 256-lane subtile over the contiguous [first..last] span of
// its lanes' chosen clusters, the clearing of visited entries to +inf, and
// the one-hot MXU winner select (_select_winner): the winner's normal and
// material are loads here.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kBoxCols = 8;   // min, max, 2 zeros
constexpr int kCluster = 128;
constexpr size_t kSharedLimit = 48 * 1024;  // dynamic shared memory without an opt-in
using pt::kNone;
using pt::RayT;

// Shared memory of a block at K threads a ray with the entries (F) cached.
template <typename F>
size_t cached_bytes(int n_boxes, int k) {
  return static_cast<size_t>(kThreads) * ((n_boxes + k - 1) / k) * sizeof(F);
}

template <int K, bool kCached, typename F>
__global__ void __launch_bounds__(kThreads)
    resident_closest_kernel(const pt::Q4<F>* __restrict__ tri, const F* __restrict__ box,
                            int n_boxes, const F* __restrict__ o, const F* __restrict__ d,
                            const F* __restrict__ t_min, const F* __restrict__ t_max,
                            F* __restrict__ t_out, int* __restrict__ idx_out,
                            F* __restrict__ n_out, int* __restrict__ m_out, int N) {
  extern __shared__ float4 smem4[];
  // This thread's column: the entry of cluster part + s K at s * 128.
  F* mine = reinterpret_cast<F*>(smem4) + threadIdx.x;
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;  // the whole team leaves together
  const unsigned mask = pt::team_mask(K);
  const RayT<F> ray = pt::load_ray(o, d, t_min, t_max, i);
  auto slab = [&](int c) {
    return pt::box_entry(box + c * kBoxCols, ray.o, ray.inv, ray.t_min, ray.t_max);
  };
  if (kCached)
    for (int c = part; c < n_boxes; c += K) mine[(c / K) * kThreads] = slab(c);
  auto entry = [&](int c) { return kCached ? mine[(c / K) * kThreads] : slab(c); };
  F best_t = INFINITY;
  int best_i = kNone;
  F e = -F(INFINITY);
  int c = -1;
  // NaN t_max stays NaN under clamp_max, so nothing passes the gate.
  while (pt::next_box<K>(n_boxes, part, mask, entry, &e, &c) &&
         e <= pt::clamp_max(ray.t_max, best_t)) {
    const F cap = pt::clamp_max(ray.t_max, best_t);
    const pt::Q4<F>* row = tri + (static_cast<size_t>(c) * kCluster + part) * (kTriCols / 4);
    F lt = INFINITY;
    int lr = kNone;
#pragma unroll 4
    for (int r = part; r < kCluster; r += K, row += K * (kTriCols / 4)) {
      F t;
      if (pt::hit_triangle(row, ray.o, ray.d, ray.t_min, cap, &t) && t < lt) {
        lt = t;  // strict: a thread's first minimum in row order
        lr = c * kCluster + r;
      }
    }
    pt::group_min(&lt, &lr, K, mask);
    if (lt < best_t || (lt == best_t && lr < best_i)) {
      best_t = lt;
      best_i = lr;
    }
  }
  if (part != 0) return;
  t_out[i] = best_t;
  if (best_i != kNone) {
    const F* row = reinterpret_cast<const F*>(tri) + static_cast<size_t>(best_i) * kTriCols;
    idx_out[i] = best_i;
    n_out[3 * i] = row[9];
    n_out[3 * i + 1] = row[10];
    n_out[3 * i + 2] = row[11];
    m_out[i] = static_cast<int>(row[12]);
  } else {
    idx_out[i] = -1;
    n_out[3 * i] = F(0);
    n_out[3 * i + 1] = F(0);
    n_out[3 * i + 2] = F(0);
    m_out[i] = 0;
  }
}

template <int K, typename F>
__global__ void __launch_bounds__(kThreads)
    resident_anyhit_kernel(const pt::Q4<F>* __restrict__ tri, const F* __restrict__ box,
                           int n_boxes, const F* __restrict__ o, const F* __restrict__ d,
                           const F* __restrict__ t_min, const F* __restrict__ t_max,
                           bool* __restrict__ occ, int N) {
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;
  const unsigned mask = pt::team_mask(K);
  const int first_lane = (threadIdx.x & 31) & ~(K - 1);  // the team's lowest lane
  const RayT<F> ray = pt::load_ray(o, d, t_min, t_max, i);
  bool hit = false;
  if (ray.t_max >= ray.t_min) {  // else an empty range (also NaN): nothing to hit
    auto row_hit = [&](int r) {
      F t;
      return pt::hit_triangle(tri + static_cast<size_t>(r) * (kTriCols / 4), ray.o, ray.d,
                              ray.t_min, ray.t_max, &t);
    };
    for (int base = 0; base < n_boxes && !hit; base += K) {
      const int c = base + part;
      const bool in = c < n_boxes && pt::box_entry(box + c * kBoxCols, ray.o, ray.inv,
                                                   ray.t_min, ray.t_max) < F(INFINITY);
      // Bit j: the team's thread j entered its box.
      unsigned entered = (__ballot_sync(mask, in) & mask) >> first_lane;
      for (; entered != 0u && !hit; entered &= entered - 1u) {
        const int r0 = (base + __ffs(entered) - 1) * kCluster;
        hit = pt::vote<K>(r0, r0 + kCluster, part, mask, row_hit);
      }
    }
  }
  if (part == 0) occ[i] = hit;
}

template <int K, typename F>
cudaError_t launch_closest(const F* tri, const F* box, int n_boxes, bool cached, const F* o,
                           const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out,
                           F* n_out, int* m_out, int N, cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  const pt::Q4<F>* rows = reinterpret_cast<const pt::Q4<F>*>(tri);
  if (!cached) {
    resident_closest_kernel<K, false, F><<<grid, kThreads, 0, stream>>>(
        rows, box, n_boxes, o, d, t_min, t_max, t_out, idx_out, n_out, m_out, N);
  } else {
    const size_t smem = cached_bytes<F>(n_boxes, K);
    if (smem > kSharedLimit) return cudaErrorInvalidValue;
    resident_closest_kernel<K, true, F><<<grid, kThreads, smem, stream>>>(
        rows, box, n_boxes, o, d, t_min, t_max, t_out, idx_out, n_out, m_out, N);
  }
  return cudaGetLastError();
}

template <int K, typename F>
cudaError_t launch_anyhit(const F* tri, const F* box, int n_boxes, const F* o, const F* d,
                          const F* t_min, const F* t_max, bool* occ, int N,
                          cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  resident_anyhit_kernel<K, F><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const pt::Q4<F>*>(tri), box, n_boxes, o, d, t_min, t_max, occ, N);
  return cudaGetLastError();
}

template <typename F>
cudaError_t closest(const F* tri, const F* box, int n_boxes, int team, bool cached, const F* o,
                    const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out,
                    F* n_out, int* m_out, int N, cudaStream_t stream) {
  PT_TEAM_LAUNCH(launch_closest, team, tri, box, n_boxes, cached, o, d, t_min, t_max, t_out,
                 idx_out, n_out, m_out, N, stream)
}

template <typename F>
cudaError_t anyhit(const F* tri, const F* box, int n_boxes, int team, const F* o, const F* d,
                   const F* t_min, const F* t_max, bool* occ, int N, cudaStream_t stream) {
  PT_TEAM_LAUNCH(launch_anyhit, team, tri, box, n_boxes, o, d, t_min, t_max, occ, N, stream)
}

template <typename F>
int run_closest(const F* tri, const F* box, int n_boxes, int team, int cached, const F* o,
                const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out, F* n_out,
                int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(closest(tri, box, n_boxes, team, cached != 0, o, d, t_min, t_max,
                                  t_out, idx_out, n_out, m_out, N,
                                  static_cast<cudaStream_t>(stream)));
}

template <typename F>
int run_anyhit(const F* tri, const F* box, int n_boxes, int team, const F* o, const F* d,
               const F* t_min, const F* t_max, bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(anyhit(tri, box, n_boxes, team, o, d, t_min, t_max, occ, N,
                                 static_cast<cudaStream_t>(stream)));
}

}  // namespace

// team: threads a ray (1, 2, 4, 8, 16 or 32); tri 16-byte aligned; cached:
// keep each ray's cluster entries in shared memory (refused past 48 KB a
// block: 128 * ceil(n_boxes / team) values of the float type). The _f64
// entry points are the same kernels in double (float64 rows, boxes, rays
// and outputs).
extern "C" int pt_resident_closest(const float* tri, const float* box, int n_boxes, int team,
                                   int cached, const float* o, const float* d,
                                   const float* t_min, const float* t_max, float* t_out,
                                   int* idx_out, float* n_out, int* m_out, int N, void* stream) {
  return run_closest(tri, box, n_boxes, team, cached, o, d, t_min, t_max, t_out, idx_out, n_out,
                     m_out, N, stream);
}

extern "C" int pt_resident_closest_f64(const double* tri, const double* box, int n_boxes,
                                       int team, int cached, const double* o, const double* d,
                                       const double* t_min, const double* t_max,
                                       double* t_out, int* idx_out, double* n_out, int* m_out,
                                       int N, void* stream) {
  return run_closest(tri, box, n_boxes, team, cached, o, d, t_min, t_max, t_out, idx_out, n_out,
                     m_out, N, stream);
}

extern "C" int pt_resident_anyhit(const float* tri, const float* box, int n_boxes, int team,
                                  const float* o, const float* d, const float* t_min,
                                  const float* t_max, bool* occ, int N, void* stream) {
  return run_anyhit(tri, box, n_boxes, team, o, d, t_min, t_max, occ, N, stream);
}

extern "C" int pt_resident_anyhit_f64(const double* tri, const double* box, int n_boxes,
                                      int team, const double* o, const double* d,
                                      const double* t_min, const double* t_max, bool* occ,
                                      int N, void* stream) {
  return run_anyhit(tri, box, n_boxes, team, o, d, t_min, t_max, occ, N, stream);
}
