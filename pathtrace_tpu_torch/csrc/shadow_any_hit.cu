// Occlusion of the NEE shadow rays: the pool's any-hit kernel.
//
// Replaces pathtrace_tpu/ops/pallas_shade.py :: _quad_anyhit_kernel
// (wrapper any_hit_quad). Same hit criteria as the JAX package's CPU route
// (ops/pallas_intersect.py :: _anyhit_kernel, one tile per class):
// Moller-Trumbore over the triangles OR the sphere quadratic with the
// near-then-far root select, for t in [eps, t_max]. Plain-torch twin:
// pathtrace_tpu_torch/ops/shade.py :: shadow_any_hit_reference.
//
// What bounds it on the H100: per-lane ALU work, ~20 flops per sphere and
// ~40 per triangle, with ~40 bytes of device traffic a lane. The geometry
// columns the test needs (center and k per sphere, v0/e1/e2 per triangle,
// ~10 KB) are staged once per block into shared memory and read as warp
// broadcasts. Occlusion needs no winner, so a lane stops at its first hit,
// and lanes with t_max < eps (no NEE query) return 0 without a sweep.
//
// The TPU kernel's MXU quadratic-form tables and bf16 splits are not
// carried over: on this card the sphere test is plain FP32 ALU work.
// Built without fast math: NaN padding rows (k = NaN) must fail every
// compare.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSphCols = 15;
constexpr int kTriCols = 22;
constexpr int kSphUse = 4;  // cx, cy, cz, k
constexpr int kTriUse = 9;  // v0, e1, e2

__global__ void __launch_bounds__(kThreads)
    shadow_any_hit_kernel(const float* __restrict__ sph, int n_sph, const float* __restrict__ tri,
                          int n_tri, const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ t_max_in, bool* __restrict__ occ, int S,
                          float eps) {
  extern __shared__ float smem[];
  float* s_sph = smem;
  float* s_tri = smem + n_sph * kSphUse;
  for (int k = threadIdx.x; k < n_sph * kSphUse; k += blockDim.x)
    s_sph[k] = sph[(k / kSphUse) * kSphCols + k % kSphUse];
  for (int k = threadIdx.x; k < n_tri * kTriUse; k += blockDim.x)
    s_tri[k] = tri[(k / kTriUse) * kTriCols + k % kTriUse];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  const float t_max = t_max_in[i];
  if (!(t_max >= eps)) {  // no query (also NaN): nothing can lie in [eps, t_max]
    occ[i] = false;
    return;
  }
  const pt::V3 o3 = pt::v3(o[i], o[S + i], o[2 * S + i]);
  const pt::V3 d3 = pt::v3(d[i], d[S + i], d[2 * S + i]);

  for (int r = 0; r < n_tri; ++r) {
    float t;
    if (pt::hit_triangle(s_tri + r * kTriUse, o3, d3, eps, t_max, &t)) {
      occ[i] = true;
      return;
    }
  }
  const float od = pt::dot3(o3, d3);
  const float oo = pt::dot3(o3, o3);
  for (int r = 0; r < n_sph; ++r) {
    float t_c = pt::sphere_root(s_sph + r * kSphUse, o3, d3, od, oo, eps);
    if (t_c >= eps && t_c <= t_max) {
      occ[i] = true;
      return;
    }
  }
  occ[i] = false;
}

}  // namespace

extern "C" int pt_shadow_any_hit(const float* sph, int n_sph, const float* tri, int n_tri,
                                 const float* o, const float* d, const float* t_max, bool* occ,
                                 int S, float eps, void* stream) {
  if (S <= 0) return 0;
  size_t smem = sizeof(float) * (static_cast<size_t>(n_sph) * kSphUse +
                                 static_cast<size_t>(n_tri) * kTriUse);
  int grid = (S + kThreads - 1) / kThreads;
  shadow_any_hit_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sph, n_sph, tri, n_tri, o, d, t_max, occ, S, eps);
  return static_cast<int>(cudaGetLastError());
}
