// Closest sphere hit and general occlusion: two kernels of the mesh path.
//
// sphere_closest replaces pathtrace_tpu/ops/pallas_intersect.py ::
// _sphere_kernel (wrapper sphere_closest): the nearest sphere with its
// outward normal (o + t d - c) * (1/r) and material. any_hit replaces
// _anyhit_kernel (wrapper any_hit): is anything hit in [t_min, t_max],
// spheres first, then triangles. Plain-torch twins: ops/intersect.py ::
// sphere_closest_reference / any_hit_reference, brute force over every row.
//
// The sphere test is csrc/geom.cuh :: sphere_root: k = |c|^2 - r^2 per row
// (NaN on padding rows and radius <= 0, which fails every compare), the
// near root unless it lies before t_min, then the far one. Strict < keeps
// the first minimum, like argmin. Directions are unit length (a = 1).
//
// Two modes each, as the JAX kernels have:
// * one tile (no boxes: <= 512 spheres, and the triangle rows of the small
//   route): every row is tested;
// * clustered (more than 512 sphere rows; the flat route's triangles): the
//   rows fall in 256-row clusters with one box each (ops/intersect.py ::
//   sphere_cluster_boxes, and Tables.leaf for triangles). A thread visits the
//   clusters in row order and skips one when pt::box_entry of its box misses
//   [t_min, min(t_max, best_t)] (any_hit: [t_min, t_max]); it tests the rows
//   of the others. Only a strictly nearer sphere replaces the best, so equal
//   t goes to the lower row and the kernel equals its brute-force twin
//   exactly; any_hit stops at the first accepted hit and returns the twin's
//   boolean. The JAX kernel visits clusters nearest-first with a strict <,
//   so it can differ from this one on equal-t ties across clusters and
//   nowhere else.
//
// Cull safety of the sphere boxes. The f32 quadratic cancels for rays far
// from the origin, so a root the twin accepts can lie off the sphere: its
// point q = o + t d has |q - c|^2 = r^2 + f, with L = |o| + |c| + r and
//   |f| <= (2^-17 + 8 |d.d - 1|) L^2.
// The first term is ~50 u L^2 (u = 2^-24) from the roundings of o.d, o.o,
// c.d, c.o, half_b, c, disc, the sqrt and the root, taken as 128 u; the
// second bounds the (d.d - 1) t^2 term of a direction that is not exactly
// unit, with |t| <= 2.5 L. So q lies within min(s, s^2 / (2 r)),
// s = sqrt(2^-17 + 8 |d.d - 1|) L, of the sphere and of its cluster's box.
// Each ray widens each sphere box by that pad, with L from |o| and the
// box's reach (the largest |c| + r in the cluster) and r its least radius;
// the slab test's own rounding (a few u L) lies far inside it, and the
// boxes also carry the triangles' 1e-4 margin. tests/test_torch_clustered.py
// checks the bound in float32 with this op order on 400,000 grazing rays
// (|o| up to ~170, r from 0.02 to 30, |d.d - 1| up to 1e-3).
//
// What bounds them on the H100: per-ray ALU work, ~20 flops a sphere row
// and ~50 a triangle row times the rows of the clusters a ray enters (~20
// flops a box); the rows are read from device memory through L1 and L2,
// every thread of a warp that enters a cluster reading the same row. One
// thread per ray, no shared memory.
//
// TPU workarounds not carried over: the per-tile key prepass over the
// cluster boxes (_keys_prepass), the front-to-back extract-min/clear-key
// loop (_extract_min), the (krows, 128) key scratch, the one-hot MXU winner
// select (_select_winner), and any_hit's per-tile triangle DMA.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSphCols = 8;   // center, k, 1/r, material, 2 zeros
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kBoxCols = 8;   // min, max; sphere boxes: reach, least radius
constexpr int kCluster = 256;
constexpr float kRootErr = 7.62939453125e-06f;  // 2^-17 = 128 u

struct Ray {
  pt::V3 o, d, inv;
  float lo, hi, od, oo;
  float len_o;  // |o|
  float gain;   // sqrt(2^-17 + 8 |d.d - 1|): the sphere pad over L
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, const float* t_min,
                                        const float* t_max, int i) {
  Ray r;
  r.o = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  r.d = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  r.inv = pt::v3(pt::safe_inv(r.d.x), pt::safe_inv(r.d.y), pt::safe_inv(r.d.z));
  r.lo = t_min[i];
  r.hi = t_max[i];
  r.od = pt::dot3(r.o, r.d);
  r.oo = pt::dot3(r.o, r.o);
  r.len_o = sqrtf(r.oo);
  r.gain = sqrtf(kRootErr + 8.0f * fabsf(pt::dot3(r.d, r.d) - 1.0f));
  return r;
}

// Does [t_min, t_up] enter sphere cluster box `box`, widened by the ray's
// root-error pad (file header)?
__device__ __forceinline__ bool enters_sphere_box(const float* __restrict__ box, const Ray& r,
                                                  float t_up) {
  float pad = r.gain * (r.len_o + box[6]);
  pad = fminf(pad, pad * pad / (2.0f * box[7]));
  const float wide[6] = {box[0] - pad, box[1] - pad, box[2] - pad,
                         box[3] + pad, box[4] + pad, box[5] + pad};
  return pt::box_entry(wide, r.o, r.inv, r.lo, t_up) < INFINITY;
}

__device__ __forceinline__ void closest_rows(const float* __restrict__ sph, int r0, int r1,
                                             const Ray& ray, float* best_t, int* best_r) {
  for (int r = r0; r < r1; ++r) {
    float t_c = pt::sphere_root(sph + r * kSphCols, ray.o, ray.d, ray.od, ray.oo, ray.lo);
    if (t_c >= ray.lo && t_c <= ray.hi && t_c < *best_t) {
      *best_t = t_c;
      *best_r = r;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    sphere_closest_kernel(const float* __restrict__ sph, int n_sph, const float* __restrict__ box,
                          int n_box, const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ t_min, const float* __restrict__ t_max,
                          float* __restrict__ t_out, int* __restrict__ idx_out,
                          float* __restrict__ n_out, int* __restrict__ m_out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const Ray ray = load_ray(o, d, t_min, t_max, i);
  float best_t = INFINITY;
  int best_r = -1;
  if (n_box == 0) closest_rows(sph, 0, n_sph, ray, &best_t, &best_r);
  for (int c = 0; c < n_box; ++c) {
    // NaN t_max propagates, as in the twin (the row test then fails too).
    if (!enters_sphere_box(box + c * kBoxCols, ray, pt::clamp_max(ray.hi, best_t))) continue;
    const int r0 = c * kCluster;
    closest_rows(sph, r0, min(r0 + kCluster, n_sph), ray, &best_t, &best_r);
  }
  t_out[i] = best_t;
  idx_out[i] = best_r;
  if (best_r >= 0) {
    const float* row = sph + best_r * kSphCols;
    const float ir = row[4];
    n_out[3 * i] = (ray.o.x + best_t * ray.d.x - row[0]) * ir;
    n_out[3 * i + 1] = (ray.o.y + best_t * ray.d.y - row[1]) * ir;
    n_out[3 * i + 2] = (ray.o.z + best_t * ray.d.z - row[2]) * ir;
    m_out[i] = static_cast<int>(row[5]);
  } else {
    n_out[3 * i] = 0.0f;
    n_out[3 * i + 1] = 0.0f;
    n_out[3 * i + 2] = 0.0f;
    m_out[i] = 0;
  }
}

__device__ __forceinline__ bool any_sphere(const float* __restrict__ sph, int r0, int r1,
                                           const Ray& ray) {
  for (int r = r0; r < r1; ++r) {
    float t_c = pt::sphere_root(sph + r * kSphCols, ray.o, ray.d, ray.od, ray.oo, ray.lo);
    if (t_c >= ray.lo && t_c <= ray.hi) return true;
  }
  return false;
}

__device__ __forceinline__ bool any_triangle(const float* __restrict__ tri, int r0, int r1,
                                             const Ray& ray) {
  for (int r = r0; r < r1; ++r) {
    float t;
    if (pt::hit_triangle(tri + static_cast<size_t>(r) * kTriCols, ray.o, ray.d, ray.lo, ray.hi,
                         &t))
      return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
    any_hit_kernel(const float* __restrict__ sph, int n_sph, const float* __restrict__ sph_box,
                   int n_sph_box, const float* __restrict__ tri, int n_tri,
                   const float* __restrict__ tri_box, int n_tri_box, const float* __restrict__ o,
                   const float* __restrict__ d, const float* __restrict__ t_min,
                   const float* __restrict__ t_max, bool* __restrict__ occ, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  if (!(t_max[i] >= t_min[i])) {  // empty range (also NaN): nothing to hit
    occ[i] = false;
    return;
  }
  const Ray ray = load_ray(o, d, t_min, t_max, i);
  bool hit = n_sph_box == 0 && any_sphere(sph, 0, n_sph, ray);
  for (int c = 0; c < n_sph_box && !hit; ++c) {
    if (!enters_sphere_box(sph_box + c * kBoxCols, ray, ray.hi)) continue;
    const int r0 = c * kCluster;
    hit = any_sphere(sph, r0, min(r0 + kCluster, n_sph), ray);
  }
  if (!hit && n_tri_box == 0) hit = any_triangle(tri, 0, n_tri, ray);
  for (int c = 0; c < n_tri_box && !hit; ++c) {
    if (!(pt::box_entry(tri_box + c * kBoxCols, ray.o, ray.inv, ray.lo, ray.hi) < INFINITY))
      continue;
    const int r0 = c * kCluster;
    hit = any_triangle(tri, r0, min(r0 + kCluster, n_tri), ray);
  }
  occ[i] = hit;
}

}  // namespace

extern "C" int pt_sphere_closest(const float* sph, int n_sph, const float* box, int n_box,
                                 const float* o, const float* d, const float* t_min,
                                 const float* t_max, float* t_out, int* idx_out, float* n_out,
                                 int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  sphere_closest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, n_sph, box, n_box, o, d, t_min, t_max, t_out, idx_out, n_out, m_out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_any_hit(const float* sph, int n_sph, const float* sph_box, int n_sph_box,
                          const float* tri, int n_tri, const float* tri_box, int n_tri_box,
                          const float* o, const float* d, const float* t_min,
                          const float* t_max, bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  any_hit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, n_sph, sph_box, n_sph_box, tri, n_tri, tri_box, n_tri_box, o, d, t_min, t_max, occ,
      N);
  return static_cast<int>(cudaGetLastError());
}
