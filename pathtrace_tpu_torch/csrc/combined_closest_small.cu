// Closest hit over the spheres AND the triangles of a small scene in one pass,
// each ray's sweep split over a team of threads.
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
// A team of K threads (1, 2, 4, 8, 16 or 32, aligned in a warp) shares one
// ray, as fused_bounce.cu's split does: thread j tests triangle rows j, j+K,
// ..., keeps its strict first minimum of (t, row), and the team combines
// them as a lexicographic (t, row) min (geom.cuh :: group_min), so every
// thread holds tri_t and tri_r; then every thread caps its sphere rows j,
// j+K, ... at min(t_max, tri_t) and the team combines them the same way.
// The merge keeps the strict sph_t < tri_t rule (equal t goes to the
// triangle), and one thread writes the winner's outputs. So the answer
// equals the twin whatever K.
//
// Both tables (<= 64 x 16 + 512 x 8 floats, <= 20 KB, 16-byte aligned) are
// staged in shared memory once per block as float4 copies; a triangle row is
// then three float4 reads and a sphere's center and k one, and the threads
// of a team read neighbouring rows. A block holds 128 rays, 128 K threads
// (up to 1,024: 64 rays at K = 16, 32 at K = 32), so the staging is paid
// once per 128 rays whatever K. Against blocks of 128 threads (128 / K rays,
// K times the blocks and the staging) it measured the same at K = 1 and
// 3-5% faster on many_spheres' 65,536 lanes at the host's K (NVIDIA H100
// 80GB HBM3, 700 W, tools/time_kernels.py flat, two runs: K = 4, 0.0421 and
// 0.0411 ms against 0.0441 and 0.0433; K = 2, 0.0433 and 0.0429 against
// 0.0453 and 0.0445).
//
// What bounds it on the H100: per-ray ALU work, ~50 flops per triangle and
// ~20 per sphere over every row, and latency: one thread per ray (the design
// before this one) gave 65,536 rays 2,048 warps, each a serial chain over
// every row (12 triangles and a sphere on Cornell, 490 rows on
// many_spheres). Split, a sphere test is still ~20 instructions without
// multiply-adds plus its shared load, so many_spheres' 32M tests take
// ~0.025 ms of instruction throughput at best. The host takes K from the
// tables' rows (kernels/binding.py :: small_team, from the times at every
// team in PERF.md): 4 on many_spheres, 1 on Cornell, whose launch costs
// more than its 13 rows.
//
// Float64: the kernel is a template on the float type as well as the team;
// the float64 instance (pt_combined_closest_small_f64) is the same code in
// double, its tables staged as pairs of 16-byte halves (<= 40 KB, under the
// 48 KB a block takes without an opt-in), at half the FP32 rate.
//
// TPU workarounds not carried over: the (3, N) lane-major ray layout with
// 1024-lane ray tiles and their padding, the 8-row table padding, and the
// one-hot bf16x3 MXU winner select (_select_winner): the winner's row is a
// load from shared memory.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kRays = 128;    // rays a block (fewer past 1,024 threads)
constexpr int kSphCols = 8;   // center, k, 1/r, material, 2 zeros
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
using pt::kNone;

// Threads of a block at K threads a ray: 128 rays, at most 1,024 threads.
template <int K>
__host__ __device__ constexpr int block_threads() {
  return kRays * K < 1024 ? kRays * K : 1024;
}

template <int K, typename F>
__global__ void __launch_bounds__(block_threads<K>())
    combined_closest_small_kernel(const pt::Q4<F>* __restrict__ sph, int n_sph,
                                  const pt::Q4<F>* __restrict__ tri, int n_tri, int num_tris,
                                  const F* __restrict__ o, const F* __restrict__ d,
                                  const F* __restrict__ t_min, const F* __restrict__ t_max,
                                  F* __restrict__ t_out, int* __restrict__ prim_out,
                                  F* __restrict__ n_out, int* __restrict__ m_out, int N) {
  constexpr int kBlock = block_threads<K>();
  extern __shared__ float4 smem4[];
  pt::Q4<F>* s_tri = reinterpret_cast<pt::Q4<F>*>(smem4);
  pt::Q4<F>* s_sph = s_tri + n_tri * (kTriCols / 4);
  for (int k = threadIdx.x; k < n_tri * (kTriCols / 4); k += kBlock) s_tri[k] = tri[k];
  for (int k = threadIdx.x; k < n_sph * (kSphCols / 4); k += kBlock) s_sph[k] = sph[k];
  __syncthreads();

  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kBlock / K) + threadIdx.x / K;
  if (i >= N) return;  // the whole team leaves together
  const unsigned mask = pt::team_mask(K);
  const pt::Vec3<F> o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  const pt::Vec3<F> d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  const F lo = t_min[i], hi = t_max[i];

  F tri_t = INFINITY;
  int tri_r = kNone;
  for (int r = part; r < n_tri; r += K) {
    F t;
    if (pt::hit_triangle(s_tri + r * (kTriCols / 4), o3, d3, lo, hi, &t) && t < tri_t) {
      tri_t = t;  // strict: a thread's first minimum in row order
      tri_r = r;
    }
  }
  pt::group_min(&tri_t, &tri_r, K, mask);

  const F sph_hi = pt::clamp_max(hi, tri_t);
  const F od = pt::dot3(o3, d3);
  const F oo = pt::dot3(o3, o3);
  F sph_t = INFINITY;
  int sph_r = kNone;
  for (int r = part; r < n_sph; r += K) {
    const F t_c = pt::sphere_root(s_sph[r * (kSphCols / 4)], o3, d3, od, oo, lo);
    if (t_c >= lo && t_c <= sph_hi && t_c < sph_t) {
      sph_t = t_c;
      sph_r = r;
    }
  }
  pt::group_min(&sph_t, &sph_r, K, mask);
  if (part != 0) return;

  if (sph_t < tri_t) {  // strictly nearer: ties go to the triangle
    const F* row = reinterpret_cast<const F*>(s_sph + sph_r * (kSphCols / 4));
    const F ir = row[4];
    t_out[i] = sph_t;
    prim_out[i] = num_tris + sph_r;
    n_out[3 * i] = (o3.x + sph_t * d3.x - row[0]) * ir;
    n_out[3 * i + 1] = (o3.y + sph_t * d3.y - row[1]) * ir;
    n_out[3 * i + 2] = (o3.z + sph_t * d3.z - row[2]) * ir;
    m_out[i] = static_cast<int>(row[5]);
  } else if (tri_r != kNone) {
    const F* row = reinterpret_cast<const F*>(s_tri + tri_r * (kTriCols / 4));
    t_out[i] = tri_t;
    prim_out[i] = tri_r;
    n_out[3 * i] = row[9];
    n_out[3 * i + 1] = row[10];
    n_out[3 * i + 2] = row[11];
    m_out[i] = static_cast<int>(row[12]);
  } else {
    t_out[i] = INFINITY;
    prim_out[i] = -1;
    n_out[3 * i] = F(0);
    n_out[3 * i + 1] = F(0);
    n_out[3 * i + 2] = F(0);
    m_out[i] = 0;
  }
}

template <int K, typename F>
cudaError_t launch(const F* sph, int n_sph, const F* tri, int n_tri, int num_tris, const F* o,
                   const F* d, const F* t_min, const F* t_max, F* t_out, int* prim_out,
                   F* n_out, int* m_out, int N, cudaStream_t stream) {
  const size_t smem = sizeof(F) * (static_cast<size_t>(n_tri) * kTriCols +
                                   static_cast<size_t>(n_sph) * kSphCols);
  constexpr int rays = block_threads<K>() / K;
  combined_closest_small_kernel<K, F>
      <<<(N + rays - 1) / rays, block_threads<K>(), smem, stream>>>(
          reinterpret_cast<const pt::Q4<F>*>(sph), n_sph,
          reinterpret_cast<const pt::Q4<F>*>(tri), n_tri, num_tris, o, d, t_min, t_max, t_out,
          prim_out, n_out, m_out, N);
  return cudaGetLastError();
}

template <typename F>
cudaError_t closest(const F* sph, int n_sph, const F* tri, int n_tri, int num_tris, int team,
                    const F* o, const F* d, const F* t_min, const F* t_max, F* t_out,
                    int* prim_out, F* n_out, int* m_out, int N, cudaStream_t stream) {
  if (N <= 0) return cudaSuccess;
  PT_TEAM_LAUNCH(launch, team, sph, n_sph, tri, n_tri, num_tris, o, d, t_min, t_max, t_out,
                 prim_out, n_out, m_out, N, stream)
}

}  // namespace

// team: threads a ray (1, 2, 4, 8, 16 or 32); sph and tri 16-byte aligned.
// The float32 and float64 instances.
extern "C" int pt_combined_closest_small(const float* sph, int n_sph, const float* tri,
                                         int n_tri, int num_tris, int team, const float* o,
                                         const float* d, const float* t_min, const float* t_max,
                                         float* t_out, int* prim_out, float* n_out, int* m_out,
                                         int N, void* stream) {
  return static_cast<int>(closest(sph, n_sph, tri, n_tri, num_tris, team, o, d, t_min, t_max,
                                  t_out, prim_out, n_out, m_out, N,
                                  static_cast<cudaStream_t>(stream)));
}

extern "C" int pt_combined_closest_small_f64(const double* sph, int n_sph, const double* tri,
                                             int n_tri, int num_tris, int team,
                                             const double* o, const double* d,
                                             const double* t_min, const double* t_max,
                                             double* t_out, int* prim_out, double* n_out,
                                             int* m_out, int N, void* stream) {
  return static_cast<int>(closest(sph, n_sph, tri, n_tri, num_tris, team, o, d, t_min, t_max,
                                  t_out, prim_out, n_out, m_out, N,
                                  static_cast<cudaStream_t>(stream)));
}
