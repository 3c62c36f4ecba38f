// Occlusion of the NEE shadow rays: the pool's any-hit kernel.
//
// Replaces pathtrace_tpu/ops/pallas_shade.py :: _quad_anyhit_kernel
// (wrapper any_hit_quad). Same hit criteria as the JAX package's CPU route
// (ops/pallas_intersect.py :: _anyhit_kernel, one tile per class):
// Moller-Trumbore over the triangles OR the sphere quadratic with the
// near-then-far root select, for t in [eps, t_max]. Plain-torch twin:
// pathtrace_tpu_torch/ops/shade.py :: shadow_any_hit_reference.
//
// What bounds it on the H100: the sweep over the rows, ~20 flops per sphere
// and ~40 per triangle, each row a dependent chain (no contracted
// multiply-adds, a correctly rounded sqrtf), with ~40 bytes of device
// traffic a lane. An unoccluded ray sweeps every row, and with one thread
// per lane the pool's 16,384 lanes fill ~4 warps an SM, so the sweep is a
// latency chain that a warp's slowest lane sets.
//
// Design: as csrc/fused_bounce.cu, a group of `split` threads (a power of two
// up to 16, chosen by the host from the row count) shares one lane; thread j
// tests triangle rows j, j+T, ..., then sphere rows j, j+T, .... Occlusion
// needs no winner: the answer is an OR over rows, which any order and any
// early exit give alike. The group votes (__any_sync over its own threads)
// after every kCheck rows a thread and leaves at the first hit it sees; all
// threads of a group share the lane, so they take the same branches around
// each vote. Lanes with t_max < eps (no NEE query) write 0 without a sweep.
// The geometry columns the test needs (center and k of a sphere as one
// float4, v0/e1/e2 of a triangle at a stride of 9 floats, at most ~10 KB;
// twice that in float64) are staged once per block into shared memory, where
// the T rows a warp reads at once sit in distinct banks. A sphere row whose discriminant is
// negative or NaN skips the square root (geom.cuh :: sphere_root).
// Blocks are lanes x T threads; the host gives each thread at most ~32 rows
// (T = 16 for the 496 rows of many_spheres, 1 up to 32 rows).
//
// The TPU kernel's MXU quadratic-form tables and bf16 splits are not
// carried over: on this card the sphere test is plain FP32 ALU work.
//
// Float64: the kernel is a template on the float type; the float64 instance
// (pt_shadow_any_hit_f64) is the same code in double, the shadow test the
// JAX float64 pool runs through pallas_intersect.any_hit (its quad tables are
// float32 only), with the same hit criteria. The H100 runs FP64 at half the
// FP32 rate, and the staged rows take twice the bytes.
// Built without fast math: NaN padding rows (k = NaN) must fail every
// compare.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kMaxThreads = 512;  // lanes x split threads a block
constexpr int kSphCols = 15;
constexpr int kTriCols = 22;
constexpr int kTriUse = 9;  // v0, e1, e2
constexpr int kCheck = 4;   // rows a thread tests between two votes of its group

template <typename F>
__global__ void __launch_bounds__(kMaxThreads)
    shadow_any_hit_kernel(const F* __restrict__ sph, int n_sph, const F* __restrict__ tri,
                          int n_tri, const F* __restrict__ o, const F* __restrict__ d,
                          const F* __restrict__ t_max_in, bool* __restrict__ occ, int S, F eps,
                          int split, int lanes) {
  extern __shared__ float4 smem4[];
  pt::Q4<F>* s_sph = reinterpret_cast<pt::Q4<F>*>(smem4);     // cx, cy, cz, k
  F* s_tri = reinterpret_cast<F*>(s_sph + n_sph);              // v0, e1, e2
  for (int k = threadIdx.x; k < n_sph; k += blockDim.x) {
    const F* row = sph + k * kSphCols;
    s_sph[k] = pt::q4(row[0], row[1], row[2], row[3]);
  }
  for (int k = threadIdx.x; k < n_tri * kTriUse; k += blockDim.x)
    s_tri[k] = tri[(k / kTriUse) * kTriCols + k % kTriUse];
  __syncthreads();

  const int T = split;
  const int part = threadIdx.x & (T - 1);
  const int i = blockIdx.x * lanes + threadIdx.x / T;
  if (i >= S) return;  // the whole group leaves together
  const F t_max = t_max_in[i];
  if (!(t_max >= eps)) {  // no query (also NaN): nothing can lie in [eps, t_max]
    if (part == 0) occ[i] = false;
    return;
  }
  // The group's threads within the warp (T <= 16 divides 32; groups are aligned).
  const unsigned group = ((1u << T) - 1u) << ((threadIdx.x & 31) & ~(T - 1));
  const pt::Vec3<F> o3 = pt::v3(o[i], o[S + i], o[2 * S + i]);
  const pt::Vec3<F> d3 = pt::v3(d[i], d[S + i], d[2 * S + i]);
  const F od = pt::dot3(o3, d3);
  const F oo = pt::dot3(o3, o3);

  // Triangles, then spheres; each group votes after every kCheck rows a thread.
  bool hit = false;
  for (int base = 0; base < n_tri; base += kCheck * T) {
#pragma unroll
    for (int c = 0; c < kCheck; ++c) {
      const int r = base + c * T + part;
      F t;
      if (!hit && r < n_tri) hit = pt::hit_triangle(s_tri + r * kTriUse, o3, d3, eps, t_max, &t);
    }
    if (__any_sync(group, hit)) {
      if (part == 0) occ[i] = true;
      return;
    }
  }
  for (int base = 0; base < n_sph; base += kCheck * T) {
#pragma unroll
    for (int c = 0; c < kCheck; ++c) {
      const int r = base + c * T + part;
      if (!hit && r < n_sph) {
        const F t_c = pt::sphere_root(s_sph[r], o3, d3, od, oo, eps);
        hit = t_c >= eps && t_c <= t_max;
      }
    }
    if (__any_sync(group, hit)) {
      if (part == 0) occ[i] = true;
      return;
    }
  }
  if (part == 0) occ[i] = false;
}

template <typename F>
int launch(const F* sph, int n_sph, const F* tri, int n_tri, const F* o, const F* d,
           const F* t_max, bool* occ, int S, F eps, int split, int lanes, void* stream) {
  if (S <= 0) return 0;
  // split: a power of two up to 16; lanes: whole warps.
  if (split < 1 || split > 16 || (split & (split - 1)) != 0 || lanes < 32 || lanes % 32 != 0 ||
      lanes * split > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  // kernels/binding.py :: shared_bytes mirrors this carve-up.
  size_t smem = sizeof(pt::Q4<F>) * static_cast<size_t>(n_sph) +
                sizeof(F) * static_cast<size_t>(n_tri) * kTriUse;
  int grid = (S + lanes - 1) / lanes;
  shadow_any_hit_kernel<F><<<grid, lanes * split, smem, static_cast<cudaStream_t>(stream)>>>(
      sph, n_sph, tri, n_tri, o, d, t_max, occ, S, eps, split, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 and float64 instances; eps comes in the instance's type.
extern "C" int pt_shadow_any_hit(const float* sph, int n_sph, const float* tri, int n_tri,
                                 const float* o, const float* d, const float* t_max, bool* occ,
                                 int S, float eps, int split, int lanes, void* stream) {
  return launch(sph, n_sph, tri, n_tri, o, d, t_max, occ, S, eps, split, lanes, stream);
}

extern "C" int pt_shadow_any_hit_f64(const double* sph, int n_sph, const double* tri, int n_tri,
                                     const double* o, const double* d, const double* t_max,
                                     bool* occ, int S, double eps, int split, int lanes,
                                     void* stream) {
  return launch(sph, n_sph, tri, n_tri, o, d, t_max, occ, S, eps, split, lanes, stream);
}
