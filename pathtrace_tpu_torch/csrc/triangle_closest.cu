// Closest triangle hit over 256-row clusters: the flat route, walked by a
// team of threads per ray.
//
// Replaces pathtrace_tpu/ops/pallas_intersect.py :: _triangle_kernel (wrapper
// triangle_closest) on the route resolve_auto picks for 64 < triangles < 4096,
// and beside more than 512 spheres for fewer triangles (the wave engine and
// the pool's composed branch alike). Plain-torch twin: ops/intersect.py ::
// triangle_closest_reference (brute force over every real row).
//
// The table is the scene's triangle rows in their build order, zero-padded to
// whole clusters of 256 rows, 16 values a row, 16-byte aligned (a row is
// three Q4 loads: float4s, or 16-byte halves of doubles), with one AABB row
// per cluster (Scene.tri_cluster_min/max, widened outward by a small margin
// in ops/intersect.py :: build_tables so that slab-test rounding never drops
// a cluster holding a hit the twin accepts; clusters with no rows carry
// inverted boxes and are never entered). The kernel is a template on the
// float type: float rows, boxes and rays, or (the float64 instance) double.
// The wrapper builds both and passes n_rows, the scene's real rows: a
// cluster's sweep ends there, so the padding rows (which would fail the
// |a| >= 1e-8 reject anyway) are never tested. On the sphere field the route
// pads 2 ground triangles to one cluster: the design before this one tested
// all 256 rows for each ray.
//
// A team of K threads (1, 2, 4, 8, 16 or 32, aligned in a warp; 128 threads
// a block, so 128 / K rays) shares one ray; every decision is taken on a
// team-reduced value, and every shuffle names the team's own lanes
// (geom.cuh :: team_mask), as in intersect.cu and resident.cu.
// - Clusters, nearest-first: each round the team finds the entered cluster
//   that follows the last visited one in ascending (entry, id) order
//   (geom.cuh :: next_box: thread j scans clusters j, j+K, ..., then
//   group_min), the entry being the slab entry into the widened box over
//   [t_min, t_max] (geom.cuh :: box_entry), and stops when there is none or
//   its entry is above min(best_t, t_max). The gate is <=, not <: out of row
//   order, a cluster entered exactly at the current best t may hold an
//   equal-t hit in a lower row, which the brute-force twin returns.
// - The sweep, split: thread j tests the cluster's real rows j, j+K, ...
//   (Moller-Trumbore, geom.cuh :: hit_triangle: 1e-8 parallel reject,
//   inclusive barycentric bounds, closed [t_min, bound]), keeps its strict
//   first minimum of (t, row), and the team combines them as a
//   lexicographic (t, row) min (group_min); the ray's best takes it on a
//   smaller t or an equal t in a lower row. The bound tightens after each
//   cluster. So the answer equals the twin whatever K. (The JAX kernel
//   visits clusters nearest-first with a strict < and keeps the first
//   cluster's row on equal t, so it can differ from this one on equal-t ties
//   across clusters, shared mesh edges, and nowhere else.)
//
// What bounds it on the H100: per-ray ALU work with divergent control flow,
// ~50 flops a triangle test times the real rows of the clusters a ray enters
// before its hit, plus ~24 a slab test per cluster and scan. One thread per
// ray in row order (the design before this one) ran the union of its warp's
// rays' clusters, far ones before the near one capped best_t, with 2,048
// warps on mesh_scene(2000)'s 65,536 rays. The host takes K from the longest
// cluster's real rows (kernels/binding.py :: flat_team, from the times at
// every team in PERF.md): one thread on the field's 2 rows. The table (<=
// 4096 rows x 64 B = 256 KB) and its boxes stay in L1/L2. No TMA or wgmma:
// the work is per-ray branching, not a product.
//
// TPU workarounds not carried over: the per-cluster HBM->VMEM DMA with its
// double buffer and semaphores, the sweep of every cluster as one whole
// 256-row tile (one vector operation on the TPU, zero padding rows
// included), the per-tile cluster prepass into key rows with extract-min/
// clear-key front-to-back order, the one-hot bf16x3 MXU winner select
// (_select_winner), the 128-lane table padding and the 1024-lane ray tiles.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kBoxCols = 8;   // min, max, 2 zeros
constexpr int kCluster = 256;
using pt::kNone;

template <int K, typename F>
__global__ void __launch_bounds__(kThreads)
    triangle_closest_kernel(const pt::Q4<F>* __restrict__ tri, const F* __restrict__ box,
                            int n_clusters, int n_rows, const F* __restrict__ o,
                            const F* __restrict__ d, const F* __restrict__ t_min,
                            const F* __restrict__ t_max, F* __restrict__ t_out,
                            int* __restrict__ idx_out, F* __restrict__ n_out,
                            int* __restrict__ m_out, int N) {
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;  // the whole team leaves together
  const unsigned mask = pt::team_mask(K);
  const pt::RayT<F> ray = pt::load_ray(o, d, t_min, t_max, i);
  auto entry = [&](int c) {
    return pt::box_entry(box + c * kBoxCols, ray.o, ray.inv, ray.t_min, ray.t_max);
  };
  F best_t = INFINITY;
  int best_i = kNone;
  F e = -F(INFINITY);
  int c = -1;
  // NaN t_max stays NaN under clamp_max, so nothing passes the gate.
  while (pt::next_box<K>(n_clusters, part, mask, entry, &e, &c) &&
         e <= pt::clamp_max(ray.t_max, best_t)) {
    const F cap = pt::clamp_max(ray.t_max, best_t);
    const int r1 = min((c + 1) * kCluster, n_rows);
    F lt = INFINITY;
    int lr = kNone;
    for (int r = c * kCluster + part; r < r1; r += K) {
      F t;
      if (pt::hit_triangle(tri + static_cast<size_t>(r) * (kTriCols / 4), ray.o, ray.d,
                           ray.t_min, cap, &t) &&
          t < lt) {
        lt = t;  // strict: a thread's first minimum in row order
        lr = r;
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
cudaError_t launch(const F* tri, const F* box, int n_clusters, int n_rows, const F* o,
                   const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out, F* n_out,
                   int* m_out, int N, cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  triangle_closest_kernel<K, F><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const pt::Q4<F>*>(tri), box, n_clusters, n_rows, o, d, t_min, t_max,
      t_out, idx_out, n_out, m_out, N);
  return cudaGetLastError();
}

template <typename F>
cudaError_t closest(const F* tri, const F* box, int n_clusters, int n_rows, int team, const F* o,
                    const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out,
                    F* n_out, int* m_out, int N, cudaStream_t stream) {
  PT_TEAM_LAUNCH(launch, team, tri, box, n_clusters, n_rows, o, d, t_min, t_max, t_out, idx_out,
                 n_out, m_out, N, stream)
}

}  // namespace

// n_rows: the table's real rows (<= n_clusters * 256); team: threads a ray
// (1, 2, 4, 8, 16 or 32); tri 16-byte aligned. pt_triangle_closest_f64 is
// the same kernel in double (float64 rows, boxes, rays and outputs).
extern "C" int pt_triangle_closest(const float* tri, const float* box, int n_clusters,
                                   int n_rows, int team, const float* o, const float* d,
                                   const float* t_min, const float* t_max, float* t_out,
                                   int* idx_out, float* n_out, int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(closest(tri, box, n_clusters, n_rows, team, o, d, t_min, t_max, t_out,
                                  idx_out, n_out, m_out, N, static_cast<cudaStream_t>(stream)));
}

extern "C" int pt_triangle_closest_f64(const double* tri, const double* box, int n_clusters,
                                       int n_rows, int team, const double* o, const double* d,
                                       const double* t_min, const double* t_max, double* t_out,
                                       int* idx_out, double* n_out, int* m_out, int N,
                                       void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(closest(tri, box, n_clusters, n_rows, team, o, d, t_min, t_max, t_out,
                                  idx_out, n_out, m_out, N, static_cast<cudaStream_t>(stream)));
}
