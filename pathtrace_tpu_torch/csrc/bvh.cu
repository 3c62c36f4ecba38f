// Closest hit and occlusion over a triangle mesh through a two-level BVH.
//
// Replaces pathtrace_tpu/ops/bvh_intersect.py :: _bvh_closest_kernel
// (wrapper triangle_closest_bvh) and _bvh_anyhit_kernel (triangle_anyhit_bvh).
// The hierarchy is the JAX package's, derived from row order: leaves of 128
// rows under groups of 16 leaves, the table padded to whole groups with zero
// rows (rejected by |a| < 1e-8), padding leaves and groups with inverted
// boxes (excluded by min <= max, not by the slab test). The wrapper builds
// the tables (ops/intersect.py :: build_tables). Plain-torch twins:
// ops/intersect.py :: bvh_closest_reference / bvh_anyhit_reference
// (brute force over every row).
//
// One thread per ray. A thread visits the groups, then their leaves, in row
// order, entering a box only if its slab entry (the `1/d` clamp of
// _entries_from) is below min(best_t, t_max), and runs Moller-Trumbore with
// the reference's epsilons (csrc/geom.cuh :: hit_triangle: 1e-8 parallel
// reject, inclusive barycentric bounds, closed [t_min, t_max]). Equal t is
// resolved to the lower row, so the answer does not depend on the visit
// order and equals the brute-force twin. The any-hit kernel stops at the
// first accepted triangle.
//
// What bounds it on the H100: per-ray ALU work, ~40 flops per triangle test
// times the triangles of the leaves a ray enters, with divergent control
// flow across a warp. The table (70k rows x 64 bytes, ~4.6 MB) stays in
// device memory and L2; threads of a warp that enter the same leaf read the
// same rows. Visiting nearest groups first, and a wider traversal per
// thread, are later work.
//
// TPU workarounds not carried over: the union sweep over 256-lane subtiles
// with packed (entry, id) int32 group keys, the 128-lane half gating, the
// lane-transposed (16, T) table and its per-supergroup DMA streaming with
// prefetch, and the MXU Moller-Trumbore form with its recentered bf16-split
// coefficient tables (_mt_coeff_table, _mt_features, _mt_ts_mxu). This is
// the plain float32 form.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kBoxCols = 8;   // min, max, 2 zeros
constexpr int kLeaf = 128;
constexpr int kGroup = 16;

using pt::box_entry;
using pt::safe_inv;

struct Ray {
  pt::V3 o, d, inv;
  float t_min, t_max;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        const float* __restrict__ t_min,
                                        const float* __restrict__ t_max, int i) {
  Ray r;
  r.o = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  r.d = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  r.inv = pt::v3(safe_inv(r.d.x), safe_inv(r.d.y), safe_inv(r.d.z));
  r.t_min = t_min[i];
  r.t_max = t_max[i];
  return r;
}

__global__ void __launch_bounds__(kThreads)
    bvh_closest_kernel(const float* __restrict__ tri, const float* __restrict__ leaf,
                       const float* __restrict__ group, int n_groups,
                       const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t_min, const float* __restrict__ t_max,
                       float* __restrict__ t_out, int* __restrict__ idx_out,
                       float* __restrict__ n_out, int* __restrict__ m_out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const Ray ray = load_ray(o, d, t_min, t_max, i);
  float best_t = INFINITY;
  int best_i = -1;
  for (int g = 0; g < n_groups; ++g) {
    if (!(box_entry(group + g * kBoxCols, ray.o, ray.inv, ray.t_min, ray.t_max) <
          fminf(best_t, ray.t_max)))
      continue;
    for (int l = g * kGroup; l < (g + 1) * kGroup; ++l) {
      float bound = fminf(best_t, ray.t_max);
      if (!(box_entry(leaf + l * kBoxCols, ray.o, ray.inv, ray.t_min, ray.t_max) < bound))
        continue;
      const float* row = tri + static_cast<size_t>(l) * kLeaf * kTriCols;
      for (int r = l * kLeaf; r < (l + 1) * kLeaf; ++r, row += kTriCols) {
        float t;
        if (pt::hit_triangle(row, ray.o, ray.d, ray.t_min, bound, &t) &&
            (t < best_t || (t == best_t && r < best_i))) {
          best_t = t;
          best_i = r;
          bound = fminf(best_t, ray.t_max);
        }
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
    bvh_anyhit_kernel(const float* __restrict__ tri, const float* __restrict__ leaf,
                      const float* __restrict__ group, int n_groups,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_min, const float* __restrict__ t_max,
                      bool* __restrict__ occ, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const Ray ray = load_ray(o, d, t_min, t_max, i);
  if (!(ray.t_max >= ray.t_min)) {  // empty range (also NaN): nothing to hit
    occ[i] = false;
    return;
  }
  for (int g = 0; g < n_groups; ++g) {
    if (!(box_entry(group + g * kBoxCols, ray.o, ray.inv, ray.t_min, ray.t_max) < ray.t_max))
      continue;
    for (int l = g * kGroup; l < (g + 1) * kGroup; ++l) {
      if (!(box_entry(leaf + l * kBoxCols, ray.o, ray.inv, ray.t_min, ray.t_max) < ray.t_max))
        continue;
      const float* row = tri + static_cast<size_t>(l) * kLeaf * kTriCols;
      for (int r = 0; r < kLeaf; ++r, row += kTriCols) {
        float t;
        if (pt::hit_triangle(row, ray.o, ray.d, ray.t_min, ray.t_max, &t)) {
          occ[i] = true;
          return;
        }
      }
    }
  }
  occ[i] = false;
}

}  // namespace

extern "C" int pt_bvh_closest(const float* tri, const float* leaf, const float* group,
                              int n_groups, const float* o, const float* d, const float* t_min,
                              const float* t_max, float* t_out, int* idx_out, float* n_out,
                              int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  bvh_closest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, leaf, group, n_groups, o, d, t_min, t_max, t_out, idx_out, n_out, m_out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_bvh_anyhit(const float* tri, const float* leaf, const float* group,
                             int n_groups, const float* o, const float* d, const float* t_min,
                             const float* t_max, bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  bvh_anyhit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, leaf, group, n_groups, o, d, t_min, t_max, occ, N);
  return static_cast<int>(cudaGetLastError());
}
