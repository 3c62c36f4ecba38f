// One round of the per-ray binned triangle traversal: closest hit and any hit.
//
// Replaces pathtrace_tpu/ops/binned_intersect.py :: _round_closest_kernel
// (wrapper _run_round_closest, driver triangle_closest_binned) and
// _round_anyhit_kernel (_run_round_anyhit, triangle_anyhit_binned). The
// drivers are plain torch in ops/binned.py: each round every live ray picks
// its nearest unvisited 256-row cluster from packed (entry, id) keys, the
// wave is sorted by that cluster id, and one of these kernels tests every
// ray of the sorted wave against the rows of its cluster. Plain-torch twins:
// ops/binned.py :: round_closest_reference / round_anyhit_reference (per ray,
// the 256 rows of its cluster in the same op order).
//
// The table is the binned route's: the scene's triangle rows zero-padded to
// whole clusters of 256 rows (padding rows fail the |a| >= 1e-8 reject).
// A ray whose key is not in [0, n_clusters) (the sentinel of a dead ray)
// gets (inf, -1, 0, 0), or false.
//
// One thread per sorted ray. The closest kernel runs Moller-Trumbore
// (csrc/geom.cuh :: hit_triangle: 1e-8 parallel reject, inclusive
// barycentric bounds, closed range) over its cluster's rows in increasing
// order and keeps only a strictly nearer hit, so equal t goes to the lower
// row, as in the twin's first minimum. The any-hit kernel stops at the first
// accepted row.
//
// What bounds it on the H100: per-ray ALU work, ~50 flops per triangle test
// times 256 rows; the rows come from device memory and L2 (70k rows x 64 B
// = 4.5 MB). The sort puts rays of one cluster on neighbouring threads, so a
// warp mostly reads the same rows at once (broadcast loads). Staging a
// block's contiguous key span in shared memory is later work.
//
// TPU workarounds not carried over: the per-cluster HBM->VMEM DMA with its
// double buffer and semaphores over the tile's [first..last] key span, the
// (T, 128) lane padding of the table, the id match folded into the value
// domain over 1024-lane tiles, and the one-hot MXU winner select
// (_select_winner): the winner's normal and material are loads here.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kCluster = 256;

__global__ void __launch_bounds__(kThreads)
    binned_round_closest_kernel(const float* __restrict__ tri, int n_clusters,
                                const float* __restrict__ o, const float* __restrict__ d,
                                const float* __restrict__ t_min, const float* __restrict__ t_up,
                                const int* __restrict__ key, float* __restrict__ t_out,
                                int* __restrict__ idx_out, float* __restrict__ n_out,
                                int* __restrict__ m_out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int k = key[i];
  float best_t = INFINITY;
  int best_i = -1;
  if (k >= 0 && k < n_clusters) {
    const pt::V3 o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    const pt::V3 d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    const float lo = t_min[i], hi = t_up[i];
    const float* row = tri + static_cast<size_t>(k) * kCluster * kTriCols;
    for (int r = k * kCluster; r < (k + 1) * kCluster; ++r, row += kTriCols) {
      float t;
      if (pt::hit_triangle(row, o3, d3, lo, pt::clamp_max(hi, best_t), &t) && t < best_t) {
        best_t = t;
        best_i = r;
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

__global__ void __launch_bounds__(kThreads)
    binned_round_anyhit_kernel(const float* __restrict__ tri, int n_clusters,
                               const float* __restrict__ o, const float* __restrict__ d,
                               const float* __restrict__ t_min, const float* __restrict__ t_max,
                               const int* __restrict__ key, bool* __restrict__ occ, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int k = key[i];
  bool hit = false;
  if (k >= 0 && k < n_clusters) {
    const pt::V3 o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    const pt::V3 d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    const float lo = t_min[i], hi = t_max[i];
    const float* row = tri + static_cast<size_t>(k) * kCluster * kTriCols;
    for (int r = 0; r < kCluster && !hit; ++r, row += kTriCols) {
      float t;
      hit = pt::hit_triangle(row, o3, d3, lo, hi, &t);
    }
  }
  occ[i] = hit;
}

}  // namespace

extern "C" int pt_binned_round_closest(const float* tri, int n_clusters, const float* o,
                                       const float* d, const float* t_min, const float* t_up,
                                       const int* key, float* t_out, int* idx_out, float* n_out,
                                       int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  binned_round_closest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, n_clusters, o, d, t_min, t_up, key, t_out, idx_out, n_out, m_out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_binned_round_anyhit(const float* tri, int n_clusters, const float* o,
                                      const float* d, const float* t_min, const float* t_max,
                                      const int* key, bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  binned_round_anyhit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, n_clusters, o, d, t_min, t_max, key, occ, N);
  return static_cast<int>(cudaGetLastError());
}
