// Closest hit over the spheres AND the triangles of a small scene in one pass.
//
// Replaces pathtrace_tpu/ops/pallas_intersect.py :: _combined_small_kernel
// (wrapper combined_closest_small): the wave engine's closest-hit route for
// scenes with at most 64 triangle rows and 512 sphere rows (the Cornell box,
// default_spheres, many_spheres). Plain-torch twin: ops/intersect.py ::
// combined_closest_small_reference.
//
// Per ray, as the TPU kernel: the closest triangle in [t_min, t_max] (csrc/
// geom.cuh :: hit_triangle, ties to the lower row), then the closest sphere
// in [t_min, min(t_max, tri_t)] (sphere_root, the k = |c|^2 - r^2 form for
// unit directions, ties to the lower row); a sphere wins only when strictly
// nearer. Outputs are resolved in-kernel: t, the GLOBAL prim id (triangle
// row, or num_tris + sphere row), the outward normal (the table's for a
// triangle, (o + t d - c) * (1/r) for a sphere) and the material; a miss is
// (inf, -1, 0, 0). Sphere padding rows carry k = NaN and fail every compare;
// triangle padding rows are zero and fail the |a| >= 1e-8 reject.
//
// What bounds it on the H100: per-ray ALU work, ~40 flops per triangle and
// ~15 per sphere over every row (up to 64 + 512). The tables (<= 64 x 16 +
// 512 x 8 floats, <= 20 KB) are staged in shared memory once per block, and
// every thread of a warp reads the same row at the same time (a broadcast).
// One thread per ray.
//
// TPU workarounds not carried over: the (3, N) lane-major ray layout with
// 1024-lane ray tiles and their padding, the 8-row table padding, and the
// one-hot bf16x3 MXU winner select (_select_winner): the winner's row is a
// load from shared memory.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSphCols = 8;   // center, k, 1/r, material, 2 zeros
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros

__global__ void __launch_bounds__(kThreads)
    combined_closest_small_kernel(const float* __restrict__ sph, int n_sph,
                                  const float* __restrict__ tri, int n_tri, int num_tris,
                                  const float* __restrict__ o, const float* __restrict__ d,
                                  const float* __restrict__ t_min,
                                  const float* __restrict__ t_max, float* __restrict__ t_out,
                                  int* __restrict__ prim_out, float* __restrict__ n_out,
                                  int* __restrict__ m_out, int N) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_sph = s_tri + n_tri * kTriCols;
  for (int k = threadIdx.x; k < n_tri * kTriCols; k += blockDim.x) s_tri[k] = tri[k];
  for (int k = threadIdx.x; k < n_sph * kSphCols; k += blockDim.x) s_sph[k] = sph[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const pt::V3 o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  const pt::V3 d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  const float lo = t_min[i], hi = t_max[i];

  float tri_t = INFINITY;
  int tri_r = -1;
  for (int r = 0; r < n_tri; ++r) {
    float t;
    if (pt::hit_triangle(s_tri + r * kTriCols, o3, d3, lo, hi, &t) && t < tri_t) {
      tri_t = t;
      tri_r = r;
    }
  }

  const float sph_hi = pt::clamp_max(hi, tri_t);
  const float od = pt::dot3(o3, d3);
  const float oo = pt::dot3(o3, o3);
  float sph_t = INFINITY;
  int sph_r = -1;
  for (int r = 0; r < n_sph; ++r) {
    float t_c = pt::sphere_root(s_sph + r * kSphCols, o3, d3, od, oo, lo);
    if (t_c >= lo && t_c <= sph_hi && t_c < sph_t) {
      sph_t = t_c;
      sph_r = r;
    }
  }

  if (sph_t < tri_t) {  // strictly nearer: ties go to the triangle
    const float* row = s_sph + sph_r * kSphCols;
    const float ir = row[4];
    t_out[i] = sph_t;
    prim_out[i] = num_tris + sph_r;
    n_out[3 * i] = (o3.x + sph_t * d3.x - row[0]) * ir;
    n_out[3 * i + 1] = (o3.y + sph_t * d3.y - row[1]) * ir;
    n_out[3 * i + 2] = (o3.z + sph_t * d3.z - row[2]) * ir;
    m_out[i] = static_cast<int>(row[5]);
  } else if (tri_r >= 0) {
    const float* row = s_tri + tri_r * kTriCols;
    t_out[i] = tri_t;
    prim_out[i] = tri_r;
    n_out[3 * i] = row[9];
    n_out[3 * i + 1] = row[10];
    n_out[3 * i + 2] = row[11];
    m_out[i] = static_cast<int>(row[12]);
  } else {
    t_out[i] = INFINITY;
    prim_out[i] = -1;
    n_out[3 * i] = 0.0f;
    n_out[3 * i + 1] = 0.0f;
    n_out[3 * i + 2] = 0.0f;
    m_out[i] = 0;
  }
}

}  // namespace

extern "C" int pt_combined_closest_small(const float* sph, int n_sph, const float* tri,
                                         int n_tri, int num_tris, const float* o, const float* d,
                                         const float* t_min, const float* t_max, float* t_out,
                                         int* prim_out, float* n_out, int* m_out, int N,
                                         void* stream) {
  if (N <= 0) return 0;
  size_t smem = sizeof(float) * (static_cast<size_t>(n_tri) * kTriCols +
                                 static_cast<size_t>(n_sph) * kSphCols);
  int grid = (N + kThreads - 1) / kThreads;
  combined_closest_small_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sph, n_sph, tri, n_tri, num_tris, o, d, t_min, t_max, t_out, prim_out, n_out, m_out, N);
  return static_cast<int>(cudaGetLastError());
}
