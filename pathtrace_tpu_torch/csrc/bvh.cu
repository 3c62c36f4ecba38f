// Closest hit and occlusion over a triangle mesh through a two-level BVH,
// walked nearest-first by a team of threads per ray.
//
// Replaces pathtrace_tpu/ops/bvh_intersect.py :: _bvh_closest_kernel
// (wrapper triangle_closest_bvh, also its counters=True mode) and
// _bvh_anyhit_kernel (triangle_anyhit_bvh). The hierarchy is the JAX
// package's, derived from row order: leaves of 128 rows under groups of 16
// leaves, the table padded to whole groups with zero rows (rejected by
// |a| < 1e-8), padding leaves and groups with inverted boxes (never
// entered). The wrapper builds the tables (ops/intersect.py :: build_tables).
// Plain-torch versions in ops/intersect.py: bvh_closest_reference /
// bvh_anyhit_reference (brute force over every row: the hits), and
// bvh_traversal_reference (this walk step for step: the hits and the
// per-ray counts of groups visited and leaves swept).
//
// Types. Both kernels are templates on the float type F: pt_bvh_closest and
// pt_bvh_anyhit are the float instances, pt_bvh_closest_f64 and
// pt_bvh_anyhit_f64 the double ones (float64 rows, boxes, rays and
// outputs). A thread's leaf entries (16 / K of them, next_leaf) are F too,
// so they take twice the registers in double.
//
// The walk. A team of K threads (1, 2, 4, 8, 16 or 32, aligned in a warp;
// 128 threads a block, so 128 / K rays) shares one ray; every decision is
// taken on a team-reduced value, so the team's control flow is uniform, and
// every shuffle and vote names the team's own lanes (csrc/geom.cuh ::
// team_mask): other teams of the warp may be elsewhere in their loops.
// - Groups, nearest-first: each round the team finds the entered group that
//   follows the last visited one in ascending (entry, id) order (the team
//   successor scan csrc/geom.cuh :: next_box, shared with the cluster walk
//   of intersect.cu: thread j scans groups j, j+K, ..., then a
//   lexicographic min over the team, group_min), and stops when there is
//   none or its entry is above min(best_t, t_max).
// - Leaves, nearest-first, inside the group: the 16 leaf entries are held in
//   registers spread over the team and visited in the same order under the
//   same bound.
// - The leaf sweep, split: thread j tests rows j, j+K, ..., so the team
//   reads K neighbouring rows at a time as Q4 loads (float4s; in the float64
//   instance 16-byte halves of doubles, a 128-byte row), keeps its
//   strict first minimum of (t, row), and the team combines them as a
//   lexicographic min over (t, row) (the rule of fused_bounce.cu, modelled
//   in tests/test_torch_sweep.py and tests/test_torch_bvh.py). The bound
//   tightens after each leaf.
// - The gate is entry <= bound, not <: out of row order, a leaf entered
//   exactly at the current best t may hold an equal-t hit in a lower row,
//   which the brute-force twin returns. Box entries are the slab entries
//   into [t_min, t_max] (geom.cuh :: box_entry); hits are Moller-Trumbore
//   with the reference's epsilons (hit_triangle: 1e-8 parallel reject,
//   inclusive barycentric bounds, closed [t_min, bound]); equal t goes to
//   the lower row. So the answer equals the brute-force twin whatever the
//   team size, and every team size gives the same counts.
// - The any hit walks the same order under t_max, votes every kCheck rows a
//   thread and stops at the first hit; an empty or NaN range occludes
//   nothing.
// - The group and leaf boxes are read from device memory through the
//   read-only cache (const __restrict__). On the H100 (PERF.md) staging them
//   in shared memory gained nothing: the group boxes staged or not time
//   alike, and staging the leaf boxes too cost 0.03-0.05 ms a launch (a
//   19 KB copy per block of 4-128 rays).
//
// What bounds it on the H100: per-ray work with divergent control flow. One
// thread per ray in row order (the design before this one) ran the union of
// a warp's 32 rays' leaves, 128 serial tests each, mostly masked, and
// entered many leaves before the nearest hit: 148x its operation bound.
// Nearest-first, a closest ray of the config-4 frame sweeps 1.9 leaves
// (242 tests against the 238 its bound counts); the team splits each sweep,
// so a warp holds 32 / K rays and diverges less, at the price of the
// team's shuffles a step (the host takes K = 16 for the closest hit and 32
// for the any hit, which only votes). What is left is instruction latency
// and the per-step successor scans and shuffles, not tests. The rows
// (4.6 MB at 70k triangles, 9.2 MB in double) stay in L2. No TMA or wgmma: the table already
// sits in L2, and the work is per-ray branching, not a product.
//
// TPU workarounds not carried over: the union sweep over 256-lane subtiles
// with packed (entry, id) int32 group keys, the 128-lane half gating, the
// lane-transposed (16, T) table and its per-supergroup DMA streaming with
// prefetch, the MXU Moller-Trumbore form with its recentered bf16-split
// coefficient tables (_mt_coeff_table, _mt_features, _mt_ts_mxu), and the
// ray sort before the trace (ops/intersect.py :: _ray_sort_key). The
// counters count per-ray work, not the TPU's subtile rounds.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kBoxCols = 8;   // min, max, 2 zeros
constexpr int kLeaf = 128;
constexpr int kGroup = 16;
constexpr int kCheck = 4;     // rows a thread tests between two votes of the any hit
using pt::kNone;
using pt::RayT;

__host__ __device__ constexpr int leaves_per_thread(int k) { return (kGroup + k - 1) / k; }

// The entered leaf after (*e, *c) in ascending (entry, id) order among a
// group's 16 leaves, whose entries the team holds in registers: thread
// `part` holds leaves part, part + K, ... (none past 16). The groups take
// geom.cuh :: next_box, the scan of the entries it computes.
template <int K, typename F>
__device__ __forceinline__ bool next_leaf(const F (&le)[leaves_per_thread(K)], int part,
                                          unsigned mask, F* e, int* c) {
  const F last_e = *e;
  const int last_c = *c;
  F best_e = INFINITY;
  int best_c = kNone;
#pragma unroll
  for (int s = 0; s < leaves_per_thread(K); ++s) {
    const int l = part + s * K;
    const F el = le[s];
    if (!(el < F(INFINITY))) continue;
    const bool after = el > last_e || (el == last_e && l > last_c);
    if (after && el < best_e) {
      best_e = el;
      best_c = l;
    }
  }
  pt::group_min(&best_e, &best_c, K, mask);
  *e = best_e;
  *c = best_c;
  return best_c != kNone;
}

// The walk: the ray's entered groups, then each group's entered leaves, in
// ascending (entry, id) order while the entry is <= bound(); calls
// sweep(leaf) on each leaf, and stops when it returns true. Counts the
// groups visited and the leaves swept. `group` holds n_groups boxes,
// `leaf` n_groups * kGroup.
template <int K, typename F, typename Bound, typename Sweep>
__device__ __forceinline__ void walk(const F* __restrict__ group, const F* __restrict__ leaf,
                                     int n_groups, const RayT<F>& ray, int part, unsigned mask,
                                     Bound bound, Sweep sweep, int* n_visited, int* n_swept) {
  auto group_entry = [&](int g) {
    return pt::box_entry(group + g * kBoxCols, ray.o, ray.inv, ray.t_min, ray.t_max);
  };
  F ge = -F(INFINITY);
  int gc = -1;
  while (pt::next_box<K>(n_groups, part, mask, group_entry, &ge, &gc) && ge <= bound()) {
    ++*n_visited;
    F le[leaves_per_thread(K)];
#pragma unroll
    for (int s = 0; s < leaves_per_thread(K); ++s) {
      const int l = part + s * K;
      le[s] = l < kGroup ? pt::box_entry(leaf + (gc * kGroup + l) * kBoxCols, ray.o, ray.inv,
                                         ray.t_min, ray.t_max)
                         : F(INFINITY);
    }
    F e = -F(INFINITY);
    int c = -1;
    while (next_leaf<K>(le, part, mask, &e, &c) && e <= bound()) {
      ++*n_swept;
      if (sweep(gc * kGroup + c)) return;
    }
  }
}

template <int K, bool kCount, typename F>
__global__ void __launch_bounds__(kThreads)
    bvh_closest_kernel(const pt::Q4<F>* __restrict__ tri, const F* __restrict__ leaf,
                       const F* __restrict__ group, int n_groups, const F* __restrict__ o,
                       const F* __restrict__ d, const F* __restrict__ t_min,
                       const F* __restrict__ t_max, F* __restrict__ t_out,
                       int* __restrict__ idx_out, F* __restrict__ n_out,
                       int* __restrict__ m_out, int* __restrict__ visited_out,
                       int* __restrict__ swept_out, int N) {
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;  // the whole team leaves together
  const unsigned mask = pt::team_mask(K);
  const RayT<F> ray = pt::load_ray(o, d, t_min, t_max, i);
  F best_t = INFINITY;
  int best_i = -1;
  int n_visited = 0, n_swept = 0;
  // NaN t_max stays NaN, so nothing passes the gate.
  auto bound = [&] { return pt::clamp_max(ray.t_max, best_t); };
  auto sweep = [&](int l) {
    const F cap = bound();
    const pt::Q4<F>* row = tri + (static_cast<size_t>(l) * kLeaf + part) * (kTriCols / 4);
    F lt = INFINITY;
    int lr = kNone;
#pragma unroll 4
    for (int r = part; r < kLeaf; r += K, row += K * (kTriCols / 4)) {
      F t;
      if (pt::hit_triangle(row, ray.o, ray.d, ray.t_min, cap, &t) && t < lt) {
        lt = t;  // strict: a thread's first minimum in row order
        lr = l * kLeaf + r;
      }
    }
    pt::group_min(&lt, &lr, K, mask);
    if (lt < best_t || (lt == best_t && lr < best_i)) {
      best_t = lt;
      best_i = lr;
    }
    return false;
  };
  walk<K>(group, leaf, n_groups, ray, part, mask, bound, sweep, &n_visited, &n_swept);
  if (part != 0) return;
  t_out[i] = best_t;
  idx_out[i] = best_i;
  if (best_i >= 0) {
    const F* row = reinterpret_cast<const F*>(tri) + static_cast<size_t>(best_i) * kTriCols;
    n_out[3 * i] = row[9];
    n_out[3 * i + 1] = row[10];
    n_out[3 * i + 2] = row[11];
    m_out[i] = static_cast<int>(row[12]);
  } else {
    n_out[3 * i] = F(0);
    n_out[3 * i + 1] = F(0);
    n_out[3 * i + 2] = F(0);
    m_out[i] = 0;
  }
  if (kCount) {
    visited_out[i] = n_visited;
    swept_out[i] = n_swept;
  }
}

template <int K, bool kCount, typename F>
__global__ void __launch_bounds__(kThreads)
    bvh_anyhit_kernel(const pt::Q4<F>* __restrict__ tri, const F* __restrict__ leaf,
                      const F* __restrict__ group, int n_groups, const F* __restrict__ o,
                      const F* __restrict__ d, const F* __restrict__ t_min,
                      const F* __restrict__ t_max, bool* __restrict__ occ,
                      int* __restrict__ visited_out, int* __restrict__ swept_out, int N) {
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;
  const unsigned mask = pt::team_mask(K);
  const RayT<F> ray = pt::load_ray(o, d, t_min, t_max, i);
  bool hit = false;
  int n_visited = 0, n_swept = 0;
  if (ray.t_max >= ray.t_min) {  // else an empty range (also NaN): nothing to hit
    auto bound = [&] { return ray.t_max; };
    auto sweep = [&](int l) {
      const pt::Q4<F>* base = tri + static_cast<size_t>(l) * kLeaf * (kTriCols / 4);
      for (int b = 0; b < kLeaf; b += kCheck * K) {  // kCheck * K divides kLeaf
        bool mine = false;
#pragma unroll
        for (int c = 0; c < kCheck; ++c) {
          const int r = b + c * K + part;
          F t;
          if (!mine)
            mine = pt::hit_triangle(base + r * (kTriCols / 4), ray.o, ray.d, ray.t_min,
                                    ray.t_max, &t);
        }
        if (__any_sync(mask, mine)) {
          hit = true;
          return true;
        }
      }
      return false;
    };
    walk<K>(group, leaf, n_groups, ray, part, mask, bound, sweep, &n_visited, &n_swept);
  }
  if (part != 0) return;
  occ[i] = hit;
  if (kCount) {
    visited_out[i] = n_visited;
    swept_out[i] = n_swept;
  }
}

template <int K, bool kCount, typename F>
cudaError_t launch_closest(const F* tri, const F* leaf, const F* group, int n_groups, const F* o,
                           const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out,
                           F* n_out, int* m_out, int* visited, int* swept, int N,
                           cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  bvh_closest_kernel<K, kCount, F><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const pt::Q4<F>*>(tri), leaf, group, n_groups, o, d, t_min, t_max,
      t_out, idx_out, n_out, m_out, visited, swept, N);
  return cudaGetLastError();
}

template <int K, bool kCount, typename F>
cudaError_t launch_anyhit(const F* tri, const F* leaf, const F* group, int n_groups, const F* o,
                          const F* d, const F* t_min, const F* t_max, bool* occ, int* visited,
                          int* swept, int N, cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  bvh_anyhit_kernel<K, kCount, F><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const pt::Q4<F>*>(tri), leaf, group, n_groups, o, d, t_min, t_max, occ,
      visited, swept, N);
  return cudaGetLastError();
}

// The instance of `fn` for team size `team` (1-32) and counters on/off (the
// float type deduced from the arguments).
#define PT_BY_TEAM(fn, team, count, ...)                                         \
  switch ((team) * 2 + ((count) ? 1 : 0)) {                                      \
    case 2: return fn<1, false>(__VA_ARGS__);                                    \
    case 3: return fn<1, true>(__VA_ARGS__);                                     \
    case 4: return fn<2, false>(__VA_ARGS__);                                    \
    case 5: return fn<2, true>(__VA_ARGS__);                                     \
    case 8: return fn<4, false>(__VA_ARGS__);                                    \
    case 9: return fn<4, true>(__VA_ARGS__);                                     \
    case 16: return fn<8, false>(__VA_ARGS__);                                   \
    case 17: return fn<8, true>(__VA_ARGS__);                                    \
    case 32: return fn<16, false>(__VA_ARGS__);                                  \
    case 33: return fn<16, true>(__VA_ARGS__);                                   \
    case 64: return fn<32, false>(__VA_ARGS__);                                  \
    case 65: return fn<32, true>(__VA_ARGS__);                                   \
    default: return cudaErrorInvalidValue;                                       \
  }

template <typename F>
cudaError_t closest(const F* tri, const F* leaf, const F* group, int n_groups, int team,
                    const F* o, const F* d, const F* t_min, const F* t_max, F* t_out,
                    int* idx_out, F* n_out, int* m_out, int* visited, int* swept, int N,
                    cudaStream_t stream) {
  PT_BY_TEAM(launch_closest, team, visited != nullptr, tri, leaf, group, n_groups, o, d, t_min,
             t_max, t_out, idx_out, n_out, m_out, visited, swept, N, stream)
}

template <typename F>
cudaError_t anyhit(const F* tri, const F* leaf, const F* group, int n_groups, int team,
                   const F* o, const F* d, const F* t_min, const F* t_max, bool* occ,
                   int* visited, int* swept, int N, cudaStream_t stream) {
  PT_BY_TEAM(launch_anyhit, team, visited != nullptr, tri, leaf, group, n_groups, o, d, t_min,
             t_max, occ, visited, swept, N, stream)
}

#undef PT_BY_TEAM

template <typename F>
int run_closest(const F* tri, const F* leaf, const F* group, int n_groups, int team, const F* o,
                const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out, F* n_out,
                int* m_out, int* visited, int* swept, int N, void* stream) {
  if (N <= 0) return 0;
  if ((visited == nullptr) != (swept == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(closest(tri, leaf, group, n_groups, team, o, d, t_min, t_max, t_out,
                                  idx_out, n_out, m_out, visited, swept, N,
                                  static_cast<cudaStream_t>(stream)));
}

template <typename F>
int run_anyhit(const F* tri, const F* leaf, const F* group, int n_groups, int team, const F* o,
               const F* d, const F* t_min, const F* t_max, bool* occ, int* visited, int* swept,
               int N, void* stream) {
  if (N <= 0) return 0;
  if ((visited == nullptr) != (swept == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(anyhit(tri, leaf, group, n_groups, team, o, d, t_min, t_max, occ,
                                 visited, swept, N, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// team: threads a ray (1, 2, 4, 8, 16 or 32); visited/swept: per-ray counts
// of groups visited and leaves swept, or null for the kernel without
// counters. The _f64 entry points are the same kernels in double (float64
// rows, boxes, rays and outputs).
extern "C" int pt_bvh_closest(const float* tri, const float* leaf, const float* group,
                              int n_groups, int team, const float* o, const float* d,
                              const float* t_min, const float* t_max, float* t_out, int* idx_out,
                              float* n_out, int* m_out, int* visited, int* swept, int N,
                              void* stream) {
  return run_closest(tri, leaf, group, n_groups, team, o, d, t_min, t_max, t_out, idx_out, n_out,
                     m_out, visited, swept, N, stream);
}

extern "C" int pt_bvh_closest_f64(const double* tri, const double* leaf, const double* group,
                                  int n_groups, int team, const double* o, const double* d,
                                  const double* t_min, const double* t_max, double* t_out,
                                  int* idx_out, double* n_out, int* m_out, int* visited,
                                  int* swept, int N, void* stream) {
  return run_closest(tri, leaf, group, n_groups, team, o, d, t_min, t_max, t_out, idx_out, n_out,
                     m_out, visited, swept, N, stream);
}

extern "C" int pt_bvh_anyhit(const float* tri, const float* leaf, const float* group,
                             int n_groups, int team, const float* o, const float* d,
                             const float* t_min, const float* t_max, bool* occ, int* visited,
                             int* swept, int N, void* stream) {
  return run_anyhit(tri, leaf, group, n_groups, team, o, d, t_min, t_max, occ, visited, swept, N,
                    stream);
}

extern "C" int pt_bvh_anyhit_f64(const double* tri, const double* leaf, const double* group,
                                 int n_groups, int team, const double* o, const double* d,
                                 const double* t_min, const double* t_max, bool* occ,
                                 int* visited, int* swept, int N, void* stream) {
  return run_anyhit(tri, leaf, group, n_groups, team, o, d, t_min, t_max, occ, visited, swept, N,
                    stream);
}
