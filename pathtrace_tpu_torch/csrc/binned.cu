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
// whole clusters of 256 rows (padding rows fail the |a| >= 1e-8 reject),
// 16 values a row, 16-byte aligned (each row read as three Q4 loads: float4s,
// or in double 16-byte halves of a 128-byte row). A ray whose key is not in
// [0, n_clusters) (the sentinel of a dead ray) gets (inf, -1, 0, 0), or
// false, and reads no row.
//
// Types. Both kernels are templates on the float type F:
// pt_binned_round_closest and pt_binned_round_anyhit are the float
// instances, the _f64 entry points the double ones (float64 rows, rays and
// outputs). The key is the int32 cluster id in both: the driver's float64
// keys are int64 (ops/binned.py :: pack_keys), but a round only needs the id.
//
// A team of K threads (1, 2, 4, 8, 16 or 32, aligned in a warp; 128 threads
// a block, so 128 / K rays) shares one sorted ray and splits its cluster's
// sweep: thread j tests rows j, j + K, ... with Moller-Trumbore
// (csrc/geom.cuh :: hit_triangle: 1e-8 parallel reject, inclusive
// barycentric bounds, closed range). The closest kernel keeps each thread's
// strict first minimum of (t, row) under min(t_up, its own best) and
// combines the team's as a lexicographic (t, row) min (geom.cuh ::
// group_min), so equal t goes to the lower row, as in the twin's first
// minimum, whatever K is; the winner's normal and material are loads. The
// any-hit kernel votes every kCheck rows a thread and stops at the first vote
// that finds a hit (geom.cuh :: vote, shared with intersect.cu's any hit).
// The team changes who tests which row, never a row's arithmetic, so every
// K gives the twin's bits.
//
// What bounds it on the H100: latency, not arithmetic. One thread a ray
// (the design before this one) ran 256 dependent row tests a ray, and the
// drivers' waves shrink round by round (the cascade launches only the live
// rays), so most rounds filled a handful of SMs with warps that each waited
// out one thread's whole chain. A team of K shortens that chain to 256 / K
// tests and fills K times the warps. The bound (chip_smoke.py) counts ~50
// flops a test, every row of a ray's cluster for the closest hit, and the
// cluster rows each distinct key reads once (70k rows x 64 B = 4.5 MB sits
// in L2; the sort puts rays of one cluster on neighbouring teams, so a warp
// mostly reads the same rows at once). No shared-memory staging of a block's
// key span: staged boxes gained nothing in bvh.cu (PERF.md).
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
using pt::kNone;

template <int K, typename F>
__global__ void __launch_bounds__(kThreads)
    binned_round_closest_kernel(const pt::Q4<F>* __restrict__ tri, int n_clusters,
                                const F* __restrict__ o, const F* __restrict__ d,
                                const F* __restrict__ t_min, const F* __restrict__ t_up,
                                const int* __restrict__ key, F* __restrict__ t_out,
                                int* __restrict__ idx_out, F* __restrict__ n_out,
                                int* __restrict__ m_out, int N) {
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;  // the whole team leaves together
  const int k = key[i];
  F best_t = INFINITY;
  int best_r = kNone;
  if (k >= 0 && k < n_clusters) {  // else the sentinel: the whole team skips the sweep
    const pt::Vec3<F> o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    const pt::Vec3<F> d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    const F lo = t_min[i], hi = t_up[i];
    const int r0 = k * kCluster;
    const pt::Q4<F>* row = tri + static_cast<size_t>(r0 + part) * (kTriCols / 4);
    // NaN t_up stays NaN under clamp_max, so no row passes.
    for (int r = r0 + part; r < r0 + kCluster; r += K, row += K * (kTriCols / 4)) {
      F t;
      if (pt::hit_triangle(row, o3, d3, lo, pt::clamp_max(hi, best_t), &t) && t < best_t) {
        best_t = t;  // strict: a thread's first minimum in row order
        best_r = r;
      }
    }
    pt::group_min(&best_t, &best_r, K, pt::team_mask(K));
  }
  if (part != 0) return;
  t_out[i] = best_t;
  if (best_r != kNone) {
    const F* row = reinterpret_cast<const F*>(tri) + static_cast<size_t>(best_r) * kTriCols;
    idx_out[i] = best_r;
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
__global__ void __launch_bounds__(kThreads)
    binned_round_anyhit_kernel(const pt::Q4<F>* __restrict__ tri, int n_clusters,
                               const F* __restrict__ o, const F* __restrict__ d,
                               const F* __restrict__ t_min, const F* __restrict__ t_max,
                               const int* __restrict__ key, bool* __restrict__ occ, int N) {
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;
  const int k = key[i];
  bool hit = false;
  if (k >= 0 && k < n_clusters) {
    const pt::Vec3<F> o3 = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    const pt::Vec3<F> d3 = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    const F lo = t_min[i], hi = t_max[i];
    auto row_hit = [&](int r) {
      F t;
      return pt::hit_triangle(tri + static_cast<size_t>(r) * (kTriCols / 4), o3, d3, lo, hi, &t);
    };
    hit = pt::vote<K>(k * kCluster, (k + 1) * kCluster, part, pt::team_mask(K), row_hit);
  }
  if (part == 0) occ[i] = hit;
}

template <int K, typename F>
cudaError_t launch_closest(const F* tri, int n_clusters, const F* o, const F* d, const F* t_min,
                           const F* t_up, const int* key, F* t_out, int* idx_out, F* n_out,
                           int* m_out, int N, cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  binned_round_closest_kernel<K, F><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const pt::Q4<F>*>(tri), n_clusters, o, d, t_min, t_up, key, t_out,
      idx_out, n_out, m_out, N);
  return cudaGetLastError();
}

template <int K, typename F>
cudaError_t launch_anyhit(const F* tri, int n_clusters, const F* o, const F* d, const F* t_min,
                          const F* t_max, const int* key, bool* occ, int N,
                          cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  binned_round_anyhit_kernel<K, F><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const pt::Q4<F>*>(tri), n_clusters, o, d, t_min, t_max, key, occ, N);
  return cudaGetLastError();
}

template <typename F>
cudaError_t closest(const F* tri, int n_clusters, int team, const F* o, const F* d,
                    const F* t_min, const F* t_up, const int* key, F* t_out, int* idx_out,
                    F* n_out, int* m_out, int N, cudaStream_t stream) {
  PT_TEAM_LAUNCH(launch_closest, team, tri, n_clusters, o, d, t_min, t_up, key, t_out, idx_out,
                 n_out, m_out, N, stream)
}

template <typename F>
cudaError_t anyhit(const F* tri, int n_clusters, int team, const F* o, const F* d,
                   const F* t_min, const F* t_max, const int* key, bool* occ, int N,
                   cudaStream_t stream) {
  PT_TEAM_LAUNCH(launch_anyhit, team, tri, n_clusters, o, d, t_min, t_max, key, occ, N, stream)
}

template <typename F>
int run_closest(const F* tri, int n_clusters, int team, const F* o, const F* d, const F* t_min,
                const F* t_up, const int* key, F* t_out, int* idx_out, F* n_out, int* m_out,
                int N, void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(closest(tri, n_clusters, team, o, d, t_min, t_up, key, t_out,
                                  idx_out, n_out, m_out, N, static_cast<cudaStream_t>(stream)));
}

template <typename F>
int run_anyhit(const F* tri, int n_clusters, int team, const F* o, const F* d, const F* t_min,
               const F* t_max, const int* key, bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(anyhit(tri, n_clusters, team, o, d, t_min, t_max, key, occ, N,
                                 static_cast<cudaStream_t>(stream)));
}

}  // namespace

// team: threads a ray (1, 2, 4, 8, 16 or 32); tri 16-byte aligned. The _f64
// entry points are the same kernels in double (float64 rows, rays and
// outputs; the keys stay int32 cluster ids).
extern "C" int pt_binned_round_closest(const float* tri, int n_clusters, int team,
                                       const float* o, const float* d, const float* t_min,
                                       const float* t_up, const int* key, float* t_out,
                                       int* idx_out, float* n_out, int* m_out, int N,
                                       void* stream) {
  return run_closest(tri, n_clusters, team, o, d, t_min, t_up, key, t_out, idx_out, n_out,
                     m_out, N, stream);
}

extern "C" int pt_binned_round_closest_f64(const double* tri, int n_clusters, int team,
                                           const double* o, const double* d,
                                           const double* t_min, const double* t_up,
                                           const int* key, double* t_out, int* idx_out,
                                           double* n_out, int* m_out, int N, void* stream) {
  return run_closest(tri, n_clusters, team, o, d, t_min, t_up, key, t_out, idx_out, n_out,
                     m_out, N, stream);
}

extern "C" int pt_binned_round_anyhit(const float* tri, int n_clusters, int team, const float* o,
                                      const float* d, const float* t_min, const float* t_max,
                                      const int* key, bool* occ, int N, void* stream) {
  return run_anyhit(tri, n_clusters, team, o, d, t_min, t_max, key, occ, N, stream);
}

extern "C" int pt_binned_round_anyhit_f64(const double* tri, int n_clusters, int team,
                                          const double* o, const double* d,
                                          const double* t_min, const double* t_max,
                                          const int* key, bool* occ, int N, void* stream) {
  return run_anyhit(tri, n_clusters, team, o, d, t_min, t_max, key, occ, N, stream);
}
