// Closest triangle hit over 256-row clusters: the flat route.
//
// Replaces pathtrace_tpu/ops/pallas_intersect.py :: _triangle_kernel (wrapper
// triangle_closest) on the route resolve_auto picks for 64 < triangles < 4096
// (the wave engine and the pool's composed branch alike). Plain-torch twin:
// ops/intersect.py :: triangle_closest_reference (brute force over every row).
//
// The table is the scene's triangle rows in their build order, zero-padded to
// whole clusters of 256 rows (padding rows fail the |a| >= 1e-8 reject), with
// one AABB row per cluster (Scene.tri_cluster_min/max, widened outward by a
// small margin in ops/intersect.py :: build_tables so that slab-test rounding
// never drops a cluster holding a hit the twin accepts; clusters with no rows
// carry inverted boxes and are never entered). The wrapper builds both.
//
// One thread per ray. A thread visits the clusters in row order, skips a
// cluster whose slab range misses [t_min, min(t_max, best_t)], and runs
// Moller-Trumbore (csrc/geom.cuh :: hit_triangle: 1e-8 parallel reject,
// inclusive barycentric bounds, closed range) over the rest. Rows are visited
// in increasing order and only a strictly nearer hit replaces the best, so
// equal t goes to the lower row and the kernel equals its brute-force twin
// exactly. The TPU kernel visits clusters nearest-first with a strict <, so it
// may differ from this one on equal-t ties across clusters (shared mesh
// edges) and nowhere else.
//
// What bounds it on the H100: per-ray ALU work, ~40 flops per triangle test
// times the rows of the clusters a ray enters (~16 slab flops per cluster),
// with divergent control flow across a warp. The table (<= 4096 rows x 64 B
// = 256 KB) stays in device memory and L2; threads of a warp that enter the
// same cluster read the same rows.
//
// TPU workarounds not carried over: the per-cluster HBM->VMEM DMA with its
// double buffer and semaphores, the per-tile cluster prepass into key rows
// with extract-min/clear-key front-to-back order, the one-hot bf16x3 MXU
// winner select (_select_winner), the 128-lane table padding and the 1024-
// lane ray tiles.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kBoxCols = 8;   // min, max, 2 zeros
constexpr int kCluster = 256;

__global__ void __launch_bounds__(kThreads)
    triangle_closest_kernel(const float* __restrict__ tri, const float* __restrict__ box,
                            int n_clusters, const float* __restrict__ o,
                            const float* __restrict__ d, const float* __restrict__ t_min,
                            const float* __restrict__ t_max, float* __restrict__ t_out,
                            int* __restrict__ idx_out, float* __restrict__ n_out,
                            int* __restrict__ m_out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const pt::V3 o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  const pt::V3 d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  const pt::V3 inv = pt::v3(pt::safe_inv(d3.x), pt::safe_inv(d3.y), pt::safe_inv(d3.z));
  const float lo = t_min[i], hi = t_max[i];
  float best_t = INFINITY;
  int best_i = -1;
  for (int c = 0; c < n_clusters; ++c) {
    float bound = pt::clamp_max(hi, best_t);  // NaN t_max propagates, as in the twin
    if (!(pt::box_entry(box + c * kBoxCols, o3, inv, lo, bound) < INFINITY)) continue;
    const float* row = tri + static_cast<size_t>(c) * kCluster * kTriCols;
    for (int r = c * kCluster; r < (c + 1) * kCluster; ++r, row += kTriCols) {
      float t;
      if (pt::hit_triangle(row, o3, d3, lo, bound, &t) && t < best_t) {
        best_t = t;
        best_i = r;
        bound = pt::clamp_max(hi, best_t);
      }
    }
  }
  t_out[i] = best_t;
  idx_out[i] = best_i;
  if (best_i >= 0) {
    const float* row = tri + static_cast<size_t>(best_i) * kTriCols;
    n_out[3 * i] = row[9];
    n_out[3 * i + 1] = row[10];
    n_out[3 * i + 2] = row[11];
    m_out[i] = static_cast<int>(row[12]);
  } else {
    n_out[3 * i] = 0.0f;
    n_out[3 * i + 1] = 0.0f;
    n_out[3 * i + 2] = 0.0f;
    m_out[i] = 0;
  }
}

}  // namespace

extern "C" int pt_triangle_closest(const float* tri, const float* box, int n_clusters,
                                   const float* o, const float* d, const float* t_min,
                                   const float* t_max, float* t_out, int* idx_out, float* n_out,
                                   int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  triangle_closest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, box, n_clusters, o, d, t_min, t_max, t_out, idx_out, n_out, m_out, N);
  return static_cast<int>(cudaGetLastError());
}
