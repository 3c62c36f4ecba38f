// Closest hit and occlusion by a whole per-ray front-to-back traversal of
// 128-row clusters, in one launch.
//
// Replaces pathtrace_tpu/ops/resident_intersect.py :: _resident_closest_kernel
// (wrapper triangle_closest_resident) and _resident_anyhit_kernel
// (triangle_anyhit_resident). Plain-torch twins: ops/intersect.py ::
// triangle_closest_reference / bvh_anyhit_reference (brute force over every
// row).
//
// The tables are the resident route's (ops/intersect.py :: build_tables):
// the scene's triangle rows zero-padded to whole clusters of 128 rows
// (padding rows fail the |a| >= 1e-8 reject), and one AABB row per cluster
// derived from the geometry, widened outward by a small margin so that
// slab-test rounding never drops a cluster holding a hit the twin accepts;
// padding clusters carry inverted boxes and are never entered.
//
// One thread per ray. A thread computes the slab entry of each cluster box
// into [t_min, t_max] (csrc/geom.cuh :: box_entry: the 1e-20 guard of 1/d
// and the min <= max validity test, as _entries_block) and visits the
// entered clusters in ascending (entry, cluster id), the order of the JAX
// argmin with clearing. It keeps no per-ray list: the next cluster is the
// lexicographic successor of the last visited (entry, id), found by one scan
// of the boxes a visit. The closest kernel stops when the next entry is
// above min(best_t, t_max), tests rows with Moller-Trumbore (hit_triangle:
// 1e-8 parallel reject, inclusive barycentric bounds, closed range) and
// breaks equal t to the lower row, so it equals the brute-force twin
// whatever the visit order. The any-hit kernel stops at the first hit.
//
// What bounds it on the H100: per-ray ALU work, the box scans (C boxes a
// visit, ~24 flops each) and ~50 flops per triangle test, with divergent
// control flow across a warp. The boxes sit in shared memory when they fit
// in 48 KB (1536 clusters, ~196k triangles; the 70k-triangle mesh has 552
// rows, 17.7 KB), else they are read from device memory; the triangle rows
// (4.5 MB at 70k triangles) come from device memory and L2.
//
// TPU workarounds not carried over: the lane-transposed (16, T) table held
// in VMEM with its in-kernel (16, P) -> (P, 16) transposes, the (C, ray
// tile) VMEM entry scratch (65,536 x 552 x 4 B = 145 MB at this size), the
// sweep of each 256-lane subtile over the contiguous [first..last] span of
// its lanes' chosen clusters, and the one-hot MXU winner select
// (_select_winner): the winner's normal and material are loads here.

#include <cuda_runtime.h>

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTriCols = 16;  // v0, e1, e2, normal, material, 3 zeros
constexpr int kBoxCols = 8;   // min, max, 2 zeros
constexpr int kCluster = 128;
constexpr int kMaxSharedBoxes = 1536;  // 1536 x 32 B = 48 KB of shared memory

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
  r.inv = pt::v3(pt::safe_inv(r.d.x), pt::safe_inv(r.d.y), pt::safe_inv(r.d.z));
  r.t_min = t_min[i];
  r.t_max = t_max[i];
  return r;
}

// The boxes in shared memory (all threads of the block copy them) when
// `shared` is set, else the table in device memory. Every thread of the
// block must call it.
__device__ __forceinline__ const float* stage_boxes(const float* __restrict__ box, int n_boxes,
                                                    bool shared, float* smem) {
  if (!shared) return box;
  for (int j = threadIdx.x; j < n_boxes * kBoxCols; j += blockDim.x) smem[j] = box[j];
  __syncthreads();
  return smem;
}

// The entered cluster after (*e, *c) in ascending (entry, id) order; sets
// (*e, *c) to it and returns true, or returns false when there is none.
__device__ __forceinline__ bool next_cluster(const float* boxes, int n_boxes, const Ray& ray,
                                             float* e, int* c) {
  const float last_e = *e;
  const int last_c = *c;
  float best_e = INFINITY;
  int best_c = -1;
  for (int k = 0; k < n_boxes; ++k) {
    const float ek = pt::box_entry(boxes + k * kBoxCols, ray.o, ray.inv, ray.t_min, ray.t_max);
    if (!(ek < INFINITY)) continue;  // not entered
    const bool after = ek > last_e || (ek == last_e && k > last_c);
    if (after && ek < best_e) {  // ids ascend: the first of equal entries wins
      best_e = ek;
      best_c = k;
    }
  }
  *e = best_e;
  *c = best_c;
  return best_c >= 0;
}

__global__ void __launch_bounds__(kThreads)
    resident_closest_kernel(const float* __restrict__ tri, const float* __restrict__ box,
                            int n_boxes, bool shared, const float* __restrict__ o,
                            const float* __restrict__ d, const float* __restrict__ t_min,
                            const float* __restrict__ t_max, float* __restrict__ t_out,
                            int* __restrict__ idx_out, float* __restrict__ n_out,
                            int* __restrict__ m_out, int N) {
  extern __shared__ float smem[];
  const float* boxes = stage_boxes(box, n_boxes, shared, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const Ray ray = load_ray(o, d, t_min, t_max, i);
  float best_t = INFINITY;
  int best_i = -1;
  float e = -INFINITY;
  int c = -1;
  while (next_cluster(boxes, n_boxes, ray, &e, &c)) {
    float bound = pt::clamp_max(ray.t_max, best_t);
    if (e > bound) break;  // every cluster left starts past the best hit
    const float* row = tri + static_cast<size_t>(c) * kCluster * kTriCols;
    for (int r = c * kCluster; r < (c + 1) * kCluster; ++r, row += kTriCols) {
      float t;
      if (pt::hit_triangle(row, ray.o, ray.d, ray.t_min, bound, &t) &&
          (t < best_t || (t == best_t && r < best_i))) {
        best_t = t;
        best_i = r;
        bound = pt::clamp_max(ray.t_max, best_t);
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
    resident_anyhit_kernel(const float* __restrict__ tri, const float* __restrict__ box,
                           int n_boxes, bool shared, const float* __restrict__ o,
                           const float* __restrict__ d, const float* __restrict__ t_min,
                           const float* __restrict__ t_max, bool* __restrict__ occ, int N) {
  extern __shared__ float smem[];
  const float* boxes = stage_boxes(box, n_boxes, shared, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const Ray ray = load_ray(o, d, t_min, t_max, i);
  if (!(ray.t_max >= ray.t_min)) {  // empty range (also NaN): nothing to hit
    occ[i] = false;
    return;
  }
  float e = -INFINITY;
  int c = -1;
  while (next_cluster(boxes, n_boxes, ray, &e, &c)) {
    const float* row = tri + static_cast<size_t>(c) * kCluster * kTriCols;
    for (int r = 0; r < kCluster; ++r, row += kTriCols) {
      float t;
      if (pt::hit_triangle(row, ray.o, ray.d, ray.t_min, ray.t_max, &t)) {
        occ[i] = true;
        return;
      }
    }
  }
  occ[i] = false;
}

size_t shared_bytes(int n_boxes) {
  return n_boxes <= kMaxSharedBoxes ? static_cast<size_t>(n_boxes) * kBoxCols * sizeof(float)
                                    : 0;
}

}  // namespace

extern "C" int pt_resident_closest(const float* tri, const float* box, int n_boxes,
                                   const float* o, const float* d, const float* t_min,
                                   const float* t_max, float* t_out, int* idx_out, float* n_out,
                                   int* m_out, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  size_t smem = shared_bytes(n_boxes);
  resident_closest_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tri, box, n_boxes, smem > 0, o, d, t_min, t_max, t_out, idx_out, n_out, m_out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_resident_anyhit(const float* tri, const float* box, int n_boxes,
                                  const float* o, const float* d, const float* t_min,
                                  const float* t_max, bool* occ, int N, void* stream) {
  if (N <= 0) return 0;
  int grid = (N + kThreads - 1) / kThreads;
  size_t smem = shared_bytes(n_boxes);
  resident_anyhit_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tri, box, n_boxes, smem > 0, o, d, t_min, t_max, occ, N);
  return static_cast<int>(cudaGetLastError());
}
