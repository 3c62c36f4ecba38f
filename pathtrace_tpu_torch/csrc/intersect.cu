// Closest sphere hit and general occlusion, walked cluster by cluster,
// nearest-first, by a team of threads per ray.
//
// sphere_closest replaces pathtrace_tpu/ops/pallas_intersect.py ::
// _sphere_kernel (wrapper sphere_closest): the nearest sphere with its
// outward normal (o + t d - c) * (1/r) and material. any_hit replaces
// _anyhit_kernel (wrapper any_hit): is anything hit in [t_min, t_max],
// spheres first, then triangles. Plain-torch versions in ops/intersect.py:
// sphere_closest_reference / any_hit_reference (brute force over every row:
// the hits) and cluster_walk_reference (this walk step for step: the hits
// and the per-ray counts of clusters visited and rows tested).
//
// The sphere test is csrc/geom.cuh :: sphere_root: k = |c|^2 - r^2 per row
// (NaN on padding rows and radius <= 0, which fails every compare), the
// near root unless it lies before t_min, then the far one. Directions are
// unit length (a = 1).
//
// Clusters. The rows fall in clusters of 256 with one box each: the sphere
// clusters past 512 sphere rows (ops/intersect.py :: sphere_cluster_boxes:
// [min | max | reach | least radius]) and the flat route's triangle
// clusters (Tables.leaf). Without boxes (<= 512 sphere rows; the small
// route's triangles) the whole table is one cluster, entered at t_min, and
// the same code sweeps it.
//
// Types. Both kernels are templates on the float type F: pt_sphere_closest
// and pt_any_hit are the float instances, pt_sphere_closest_f64 and
// pt_any_hit_f64 the double ones (float64 rays, tables, boxes and outputs;
// a row's four values read as one Q4<F>, a float4 or two 16-byte halves).
//
// The walk. A team of K threads (1, 2, 4, 8, 16 or 32, aligned in a warp;
// 128 threads a block, so 128 / K rays) shares one ray; every decision is
// taken on a team-reduced value, and every shuffle and vote names the
// team's own lanes (geom.cuh :: team_mask), as in bvh.cu.
// - Clusters, nearest-first: each round the team finds the entered cluster
//   that follows the last visited one in ascending (entry, id) order
//   (geom.cuh :: next_box, the successor scan bvh.cu walks its groups with:
//   thread j scans clusters j, j+K, ..., then group_min), and stops when
//   there is none or its entry is above the bound, min(best_t, t_max) for
//   the closest hit and t_max for the any hit. A sphere cluster's entry is
//   the slab entry into its box widened by the ray's root-error pad (below),
//   a triangle cluster's the plain slab entry (geom.cuh :: box_entry).
// - The sweep, split: thread j tests rows j, j+K, ... of the cluster (a
//   sphere row's center and k as one float4, a triangle row as three),
//   keeps its strict first minimum of (t, row) under the bound, and the team
//   combines them as a lexicographic (t, row) min (group_min); the ray's
//   best takes it on a smaller t or an equal t in a lower row. The bound
//   tightens after each cluster.
// - The gate is entry <= bound, not <: out of row order, a cluster entered
//   exactly at the current best t may hold an equal-t hit in a lower row,
//   which the brute-force twin returns. So the answer equals the twin
//   whatever the team size. (The JAX kernel visits clusters nearest-first
//   with a strict < and keeps the first cluster's row on equal t, so it can
//   differ from this one on equal-t ties across clusters and nowhere else.)
// - The any hit walks the sphere clusters, then the triangle clusters, in
//   the same order under t_max, votes every kCheck rows a thread (geom.cuh
//   :: vote) and stops at the first hit; an empty or NaN range occludes
//   nothing. The order is for speed: any order gives the same boolean.
//
// Cull safety of the sphere boxes. The quadratic cancels for rays far from
// the origin, so a root the twin accepts can lie off the sphere: its point
// q = o + t d has |q - c|^2 = r^2 + f, with L = |o| + |c| + r and
//   |f| <= (128 u + 8 |d.d - 1|) L^2,
// u the unit roundoff of the type (2^-24 in float, 2^-53 in double). The
// first term is ~50 u L^2 from the roundings of o.d, o.o, c.d, c.o, half_b,
// c, disc, the sqrt and the root, each a relative error of u in a term of
// at most ~L^2 (the same count in either type), taken as 128 u: 2^-17 in
// float, 2^-46 in double (RootErr); the second bounds the (d.d - 1) t^2
// term of a direction that is not exactly unit, with |t| <= 2.5 L. So q lies
// within min(s, s^2 / (2 r)), s = sqrt(128 u + 8 |d.d - 1|) L, of the sphere
// and of its cluster's box. Each ray widens each sphere box by that pad,
// with L from |o| and the box's reach (the largest |c| + r in the cluster)
// and r its least radius; the boxes also carry the triangles' 1e-4 margin
// (1e-4 (1 + the box's largest |coordinate|), ops/intersect.py :: _widen).
// The slab test's own rounding (a few u L) lies inside the pad in either
// type: s >= sqrt(128 u) L, and s^2 / (2 r) >= 64 u L^2 / r >= 64 u L since
// L >= r. In double the pad shrinks to ~7e-15 L^2 / r, and the 1e-4
// margin, ~10^10 times the root error, carries the safety. A pad too wide
// costs only work; one too narrow would drop hits. tests/test_torch_clustered.py
// checks the bound in float32 with this op order on 400,000 grazing rays
// (|o| up to ~170, r from 0.02 to 30, |d.d - 1| up to 1e-3), and
// tests/test_torch_f64_routes.py in float64 with the float64 pad. For the
// ordered walk: a root t the twin accepts has its point inside its
// cluster's widened box, so the cluster's entry is <= t; while the ray's
// best is >= t the bound is too, so the walk reaches that cluster before its
// bound drops below the root, and a root above the best cannot be the
// answer.
//
// What bounds them on the H100: per-ray work with divergent control flow,
// ~20 flops a sphere row and ~50 a triangle row times the rows of the
// clusters a ray enters. One thread per ray in row order (the design before
// this one) gave 128 blocks of 128 threads at the field frame's 16,384
// rays, four warps an SM with nothing to hide each row's load and square
// root, and each warp ran the union of its 32 rays' clusters, every entered
// cluster before the nearest hit. Nearest-first, a closest ray sweeps few
// clusters past its hit; the team splits each sweep, so a frame's rays fill
// K times the warps and each thread tests 256 / K rows a cluster. On the
// 1,940-sphere field (PERF.md) a closest ray visits 3.1 clusters, 682 rows
// against the 676 its bound counts (the clusters overlap), and the host
// takes K = 8 for the closest hit and 32 for the any hit, which only votes
// (kernels/binding.py :: cluster_team). What is left is latency, the
// per-round scans and shuffles, and divergence, not tests. No TMA, wgmma or
// shared-memory staging: the whole sphere table (64 KB at 1,940 spheres)
// sits in L1/L2, the work is per-ray branching, not a product, and staging
// bvh.cu's boxes measured no gain (PERF.md).
//
// TPU workarounds not carried over: the per-tile key prepass over the
// cluster boxes (_keys_prepass), the front-to-back extract-min/clear-key
// loop over the tile's least entries (_extract_min, _clear_key), the
// (krows, 128) key scratch, the one-hot MXU winner select (_select_winner),
// and any_hit's per-tile double-buffered triangle DMA.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSphCols = 8;   // center, k, 1/r, material, 2 zeros
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kBoxCols = 8;   // min, max; sphere boxes: reach, least radius
constexpr int kCluster = 256;
using pt::kNone;

// The root-error pad's first term over L^2 (file header), by type: 128 u.
template <typename F>
struct RootErr;
template <>
struct RootErr<float> {
  static constexpr float value = 7.62939453125e-06f;  // 2^-17, u = 2^-24
};
template <>
struct RootErr<double> {
  static constexpr double value = 1.4210854715202004e-14;  // 2^-46, u = 2^-53
};

template <typename F>
struct RayT {
  pt::Vec3<F> o, d, inv;  // inv: the clusters' slab test
  F lo, hi, od, oo;
  F len_o;  // |o|
  F gain;   // sqrt(128 u + 8 |d.d - 1|): the sphere pad over L
};

template <typename F>
__device__ __forceinline__ RayT<F> load_ray(const F* o, const F* d, const F* t_min,
                                            const F* t_max, int i) {
  RayT<F> r;
  r.o = pt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  r.d = pt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  r.lo = t_min[i];
  r.hi = t_max[i];
  r.od = pt::dot3(r.o, r.d);
  r.oo = pt::dot3(r.o, r.o);
  r.inv = pt::v3(pt::safe_inv(r.d.x), pt::safe_inv(r.d.y), pt::safe_inv(r.d.z));
  r.len_o = pt::sqrt_(r.oo);
  r.gain = pt::sqrt_(RootErr<F>::value + F(8) * pt::abs_(pt::dot3(r.d, r.d) - F(1)));
  return r;
}

// Entry of [t_min, t_max] into sphere cluster box `box`, widened by the
// ray's root-error pad (file header); +inf when it misses.
template <typename F>
__device__ __forceinline__ F sphere_entry(const F* __restrict__ box, const RayT<F>& r) {
  F pad = r.gain * (r.len_o + box[6]);
  pad = pt::fmin_(pad, pad * pad / (F(2) * box[7]));
  const F wide[6] = {box[0] - pad, box[1] - pad, box[2] - pad,
                     box[3] + pad, box[4] + pad, box[5] + pad};
  return pt::box_entry(wide, r.o, r.inv, r.lo, r.hi);
}

// The walk over a table of n_rows rows: its n_box clusters of kCluster rows
// with entry(c), or (n_box = 0) one cluster of every row, entered at t_min;
// in ascending (entry, id) order while the entry is <= bound(). Calls
// sweep(first row, end row) on each cluster and returns true as soon as one
// returns true.
template <int K, typename F, typename Entry, typename Bound, typename Sweep>
__device__ __forceinline__ bool walk(int n_rows, int n_box, const RayT<F>& ray, int part,
                                     unsigned mask, Entry entry, Bound bound, Sweep sweep) {
  if (n_rows <= 0) return false;
  const int n = n_box > 0 ? n_box : 1;
  const int size = n_box > 0 ? kCluster : n_rows;
  auto enter = [&](int c) { return n_box > 0 ? entry(c) : ray.lo; };
  F e = -F(INFINITY);
  int c = -1;
  while (pt::next_box<K>(n, part, mask, enter, &e, &c) && e <= bound()) {
    const int r0 = c * size;
    if (sweep(r0, min(r0 + size, n_rows))) return true;
  }
  return false;
}

template <int K, typename F>
__global__ void __launch_bounds__(kThreads)
    sphere_closest_kernel(const pt::Q4<F>* __restrict__ sph, int n_sph,
                          const F* __restrict__ box, int n_box, const F* __restrict__ o,
                          const F* __restrict__ d, const F* __restrict__ t_min,
                          const F* __restrict__ t_max, F* __restrict__ t_out,
                          int* __restrict__ idx_out, F* __restrict__ n_out,
                          int* __restrict__ m_out, int N) {
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;  // the whole team leaves together
  const unsigned mask = pt::team_mask(K);
  const RayT<F> ray = load_ray(o, d, t_min, t_max, i);
  F best_t = INFINITY;
  int best_r = kNone;
  // NaN t_max stays NaN, so nothing passes the gate or the row test.
  auto bound = [&] { return pt::clamp_max(ray.hi, best_t); };
  auto entry = [&](int c) { return sphere_entry(box + c * kBoxCols, ray); };
  auto sweep = [&](int r0, int r1) {
    const F cap = bound();
    F lt = INFINITY;
    int lr = kNone;
    for (int r = r0 + part; r < r1; r += K) {
      const F t = pt::sphere_root(sph[r * (kSphCols / 4)], ray.o, ray.d, ray.od, ray.oo,
                                  ray.lo);
      if (t >= ray.lo && t <= cap && t < lt) {
        lt = t;  // strict: a thread's first minimum in row order
        lr = r;
      }
    }
    pt::group_min(&lt, &lr, K, mask);
    if (lt < best_t || (lt == best_t && lr < best_r)) {
      best_t = lt;
      best_r = lr;
    }
    return false;
  };
  walk<K>(n_sph, n_box, ray, part, mask, entry, bound, sweep);
  if (part != 0) return;
  t_out[i] = best_t;
  if (best_r != kNone) {
    const F* row = reinterpret_cast<const F*>(sph) + best_r * kSphCols;
    const F ir = row[4];
    idx_out[i] = best_r;
    n_out[3 * i] = (ray.o.x + best_t * ray.d.x - row[0]) * ir;
    n_out[3 * i + 1] = (ray.o.y + best_t * ray.d.y - row[1]) * ir;
    n_out[3 * i + 2] = (ray.o.z + best_t * ray.d.z - row[2]) * ir;
    m_out[i] = static_cast<int>(row[5]);
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
    any_hit_kernel(const pt::Q4<F>* __restrict__ sph, int n_sph, const F* __restrict__ sph_box,
                   int n_sph_box, const pt::Q4<F>* __restrict__ tri, int n_tri,
                   const F* __restrict__ tri_box, int n_tri_box, const F* __restrict__ o,
                   const F* __restrict__ d, const F* __restrict__ t_min,
                   const F* __restrict__ t_max, bool* __restrict__ occ, int N) {
  const int part = threadIdx.x & (K - 1);
  const int i = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (i >= N) return;
  const unsigned mask = pt::team_mask(K);
  const RayT<F> ray = load_ray(o, d, t_min, t_max, i);
  bool hit = false;
  if (ray.hi >= ray.lo) {  // else an empty range (also NaN): nothing to hit
    auto bound = [&] { return ray.hi; };
    auto sph_hit = [&](int r) {
      const F t = pt::sphere_root(sph[r * (kSphCols / 4)], ray.o, ray.d, ray.od, ray.oo, ray.lo);
      return t >= ray.lo && t <= ray.hi;
    };
    auto tri_hit = [&](int r) {
      F t;
      return pt::hit_triangle(tri + static_cast<size_t>(r) * (kTriCols / 4), ray.o, ray.d,
                              ray.lo, ray.hi, &t);
    };
    auto sph_sweep = [&](int r0, int r1) { return pt::vote<K>(r0, r1, part, mask, sph_hit); };
    auto tri_sweep = [&](int r0, int r1) { return pt::vote<K>(r0, r1, part, mask, tri_hit); };
    auto sph_entry = [&](int c) { return sphere_entry(sph_box + c * kBoxCols, ray); };
    auto tri_entry = [&](int c) {
      return pt::box_entry(tri_box + c * kBoxCols, ray.o, ray.inv, ray.lo, ray.hi);
    };
    hit = walk<K>(n_sph, n_sph_box, ray, part, mask, sph_entry, bound, sph_sweep) ||
          walk<K>(n_tri, n_tri_box, ray, part, mask, tri_entry, bound, tri_sweep);
  }
  if (part == 0) occ[i] = hit;
}

template <int K, typename F>
cudaError_t launch_closest(const F* sph, int n_sph, const F* box, int n_box, const F* o,
                           const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out,
                           F* n_out, int* m_out, int N, cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  sphere_closest_kernel<K, F><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const pt::Q4<F>*>(sph), n_sph, box, n_box, o, d, t_min, t_max, t_out,
      idx_out, n_out, m_out, N);
  return cudaGetLastError();
}

template <int K, typename F>
cudaError_t launch_any_hit(const F* sph, int n_sph, const F* sph_box, int n_sph_box,
                           const F* tri, int n_tri, const F* tri_box, int n_tri_box,
                           const F* o, const F* d, const F* t_min, const F* t_max, bool* occ,
                           int N, cudaStream_t stream) {
  const int grid = (N + kThreads / K - 1) / (kThreads / K);
  any_hit_kernel<K, F><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const pt::Q4<F>*>(sph), n_sph, sph_box, n_sph_box,
      reinterpret_cast<const pt::Q4<F>*>(tri), n_tri, tri_box, n_tri_box, o, d, t_min, t_max,
      occ, N);
  return cudaGetLastError();
}

template <typename F>
cudaError_t closest(const F* sph, int n_sph, const F* box, int n_box, int team, const F* o,
                    const F* d, const F* t_min, const F* t_max, F* t_out, int* idx_out, F* n_out,
                    int* m_out, int N, cudaStream_t stream) {
  PT_TEAM_LAUNCH(launch_closest, team, sph, n_sph, box, n_box, o, d, t_min, t_max, t_out, idx_out,
                 n_out, m_out, N, stream)
}

template <typename F>
cudaError_t any_hit(const F* sph, int n_sph, const F* sph_box, int n_sph_box, const F* tri,
                    int n_tri, const F* tri_box, int n_tri_box, int team, const F* o, const F* d,
                    const F* t_min, const F* t_max, bool* occ, int N, cudaStream_t stream) {
  PT_TEAM_LAUNCH(launch_any_hit, team, sph, n_sph, sph_box, n_sph_box, tri, n_tri, tri_box,
                 n_tri_box, o, d, t_min, t_max, occ, N, stream)
}

}  // namespace

// team: threads a ray (1, 2, 4, 8, 16 or 32); sph and tri 16-byte aligned;
// n_box = 0: one cluster of every row. The _f64 entry points are the same
// kernels in double: every pointer of a float type points to doubles.
extern "C" int pt_sphere_closest(const float* sph, int n_sph, const float* box, int n_box,
                                 int team, const float* o, const float* d, const float* t_min,
                                 const float* t_max, float* t_out, int* idx_out, float* n_out,
                                 int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(closest(sph, n_sph, box, n_box, team, o, d, t_min, t_max, t_out,
                                  idx_out, n_out, m_out, N, static_cast<cudaStream_t>(stream)));
}

extern "C" int pt_sphere_closest_f64(const double* sph, int n_sph, const double* box, int n_box,
                                     int team, const double* o, const double* d,
                                     const double* t_min, const double* t_max, double* t_out,
                                     int* idx_out, double* n_out, int* m_out, int N,
                                     void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(closest(sph, n_sph, box, n_box, team, o, d, t_min, t_max, t_out,
                                  idx_out, n_out, m_out, N, static_cast<cudaStream_t>(stream)));
}

extern "C" int pt_any_hit(const float* sph, int n_sph, const float* sph_box, int n_sph_box,
                          const float* tri, int n_tri, const float* tri_box, int n_tri_box,
                          int team, const float* o, const float* d, const float* t_min,
                          const float* t_max, bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(any_hit(sph, n_sph, sph_box, n_sph_box, tri, n_tri, tri_box,
                                  n_tri_box, team, o, d, t_min, t_max, occ, N,
                                  static_cast<cudaStream_t>(stream)));
}

extern "C" int pt_any_hit_f64(const double* sph, int n_sph, const double* sph_box,
                              int n_sph_box, const double* tri, int n_tri,
                              const double* tri_box, int n_tri_box, int team, const double* o,
                              const double* d, const double* t_min, const double* t_max,
                              bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  return static_cast<int>(any_hit(sph, n_sph, sph_box, n_sph_box, tri, n_tri, tri_box,
                                  n_tri_box, team, o, d, t_min, t_max, occ, N,
                                  static_cast<cudaStream_t>(stream)));
}
