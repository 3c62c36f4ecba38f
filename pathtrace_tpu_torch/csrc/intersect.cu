// Closest sphere hit and general occlusion: two kernels of the mesh path.
//
// sphere_closest replaces pathtrace_tpu/ops/pallas_intersect.py ::
// _sphere_kernel (wrapper sphere_closest) in its one-tile mode: the nearest
// sphere with its outward normal (o + t d - c) * (1/r) and material.
// any_hit replaces _anyhit_kernel (wrapper any_hit): is anything hit in
// [t_min, t_max], spheres first, then triangles; the mesh path passes the
// spheres only (no triangle rows). Plain-torch twins: ops/intersect.py ::
// sphere_closest_reference / any_hit_reference.
//
// The sphere test is csrc/geom.cuh :: sphere_root: k = |c|^2 - r^2 per row
// (NaN on padding rows and radius <= 0, which fails every compare), the
// near root unless it lies before t_min, then the far one. Strict < keeps
// the first minimum, like argmin. Directions are unit length (a = 1).
//
// What bounds them on the H100: per-ray ALU work over few rows (3 spheres in
// the mesh scene); the rows are read from device memory through L1, every
// thread of a warp reading the same row. One thread per ray, no shared
// memory. The TPU kernel's morton-cluster AABB prepass with front-to-back
// extract-min (for more than 512 spheres), its key buffers and its
// per-tile triangle DMA are not carried over: with the rows in L1 and L2 a
// ray tests every row.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSphCols = 8;   // center, k, 1/r, material, 2 zeros
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros

__global__ void __launch_bounds__(kThreads)
    sphere_closest_kernel(const float* __restrict__ sph, int n_sph,
                          const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ t_min, const float* __restrict__ t_max,
                          float* __restrict__ t_out, int* __restrict__ idx_out,
                          float* __restrict__ n_out, int* __restrict__ m_out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const pt::V3 o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  const pt::V3 d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  const float lo = t_min[i], hi = t_max[i];
  const float od = pt::dot3(o3, d3);
  const float oo = pt::dot3(o3, o3);
  float best_t = INFINITY;
  int best_r = -1;
  for (int r = 0; r < n_sph; ++r) {
    float t_c = pt::sphere_root(sph + r * kSphCols, o3, d3, od, oo, lo);
    if (t_c >= lo && t_c <= hi && t_c < best_t) {
      best_t = t_c;
      best_r = r;
    }
  }
  t_out[i] = best_t;
  idx_out[i] = best_r;
  if (best_r >= 0) {
    const float* row = sph + best_r * kSphCols;
    const float ir = row[4];
    n_out[3 * i] = (o3.x + best_t * d3.x - row[0]) * ir;
    n_out[3 * i + 1] = (o3.y + best_t * d3.y - row[1]) * ir;
    n_out[3 * i + 2] = (o3.z + best_t * d3.z - row[2]) * ir;
    m_out[i] = static_cast<int>(row[5]);
  } else {
    n_out[3 * i] = 0.0f;
    n_out[3 * i + 1] = 0.0f;
    n_out[3 * i + 2] = 0.0f;
    m_out[i] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    any_hit_kernel(const float* __restrict__ sph, int n_sph, const float* __restrict__ tri,
                   int n_tri, const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_min, const float* __restrict__ t_max,
                   bool* __restrict__ occ, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float lo = t_min[i], hi = t_max[i];
  if (!(hi >= lo)) {  // empty range (also NaN): nothing to hit
    occ[i] = false;
    return;
  }
  const pt::V3 o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  const pt::V3 d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  const float od = pt::dot3(o3, d3);
  const float oo = pt::dot3(o3, o3);
  for (int r = 0; r < n_sph; ++r) {
    float t_c = pt::sphere_root(sph + r * kSphCols, o3, d3, od, oo, lo);
    if (t_c >= lo && t_c <= hi) {
      occ[i] = true;
      return;
    }
  }
  for (int r = 0; r < n_tri; ++r) {
    float t;
    if (pt::hit_triangle(tri + static_cast<size_t>(r) * kTriCols, o3, d3, lo, hi, &t)) {
      occ[i] = true;
      return;
    }
  }
  occ[i] = false;
}

}  // namespace

extern "C" int pt_sphere_closest(const float* sph, int n_sph, const float* o, const float* d,
                                 const float* t_min, const float* t_max, float* t_out,
                                 int* idx_out, float* n_out, int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  sphere_closest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, n_sph, o, d, t_min, t_max, t_out, idx_out, n_out, m_out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_any_hit(const float* sph, int n_sph, const float* tri, int n_tri,
                          const float* o, const float* d, const float* t_min,
                          const float* t_max, bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  any_hit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, n_sph, tri, n_tri, o, d, t_min, t_max, occ, N);
  return static_cast<int>(cudaGetLastError());
}
