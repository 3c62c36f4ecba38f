// 3-vector helpers and the ray-primitive tests shared by the kernels.
//
// Every helper keeps the operation order of the plain-torch twins in
// ops/shade.py (sums left to right, no reassociation); the library is
// built with -fmad=false, so no multiply-add is contracted either, and a
// kernel and its twin round alike everywhere except in cosf/sinf.
// Max/min follow torch.clamp_min/clamp_max: a NaN operand propagates
// (fmaxf/fminf would drop it and turn a NaN the twin screens out later into
// a finite value).
#pragma once

#include <math.h>

namespace pt {

constexpr double kPi = 3.14159265358979323846;
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kTwoPiF = static_cast<float>(2.0 * kPi);
constexpr float kInvPiF = static_cast<float>(1.0 / kPi);
// Inexact constants are rounded from double, as the twin's Python floats are.
constexpr float kF_1em8 = static_cast<float>(1e-8);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 add3(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale3(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg3(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 mul3(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }

// Components divided by the length; zero vectors pass through unchanged.
__device__ __forceinline__ V3 normalize3(V3 a) {
  float ln = sqrtf(dot3(a, a));
  bool pos = ln > 0.0f;
  float safe = pos ? ln : 1.0f;
  return pos ? V3{a.x / safe, a.y / safe, a.z / safe} : a;
}

__device__ __forceinline__ bool finite1(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite3(V3 a) { return finite1(a.x) && finite1(a.y) && finite1(a.z); }
__device__ __forceinline__ float forz(float x) { return finite1(x) ? x : 0.0f; }
__device__ __forceinline__ V3 forz3(V3 a) { return V3{forz(a.x), forz(a.y), forz(a.z)}; }

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// Moller-Trumbore against one triangle given as v0, e1, e2. Sets *t_out and
// returns whether it is a hit with t in [eps, t_max] (twin:
// ops/shade.py::_tri_hits).
__device__ __forceinline__ bool hit_triangle(float v0x, float v0y, float v0z, float e1x,
                                             float e1y, float e1z, float e2x, float e2y,
                                             float e2z, V3 o, V3 d, float eps, float t_max,
                                             float* t_out) {
  float hx = d.y * e2z - d.z * e2y;
  float hy = d.z * e2x - d.x * e2z;
  float hz = d.x * e2y - d.y * e2x;
  float a = e1x * hx + e1y * hy + e1z * hz;
  float f = 1.0f / a;
  float sx = o.x - v0x, sy = o.y - v0y, sz = o.z - v0z;
  float uu = f * (sx * hx + sy * hy + sz * hz);
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  float vv = f * (d.x * qx + d.y * qy + d.z * qz);
  float t = f * (e2x * qx + e2y * qy + e2z * qz);
  *t_out = t;
  return fabsf(a) >= kF_1em8 && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f && uu + vv <= 1.0f &&
         t >= eps && t <= t_max;
}

// The same on a table row holding v0, e1, e2 in its first nine floats.
__device__ __forceinline__ bool hit_triangle(const float* row, V3 o, V3 d, float eps, float t_max,
                                             float* t_out) {
  return hit_triangle(row[0], row[1], row[2], row[3], row[4], row[5], row[6], row[7], row[8], o,
                      d, eps, t_max, t_out);
}

// The same on a 16-float row aligned to 16 bytes, read as three float4 loads.
__device__ __forceinline__ bool hit_triangle(const float4* row, V3 o, V3 d, float eps,
                                             float t_max, float* t_out) {
  const float4 a = row[0], b = row[1], c = row[2];
  return hit_triangle(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, o, d, eps, t_max, t_out);
}

// The (t, row) lexicographic min over each aligned team of `k` threads (a
// power of two up to 32) of a warp; `mask` holds the calling thread's team
// (or more: every thread in it must make the same call). Every thread ends
// with its team's least t and, among equal t, the least row. No t may be NaN
// (a miss is inf), so this is the strict first-minimum argmin over the rows
// the team's threads kept.
__device__ __forceinline__ void group_min(float* t, int* row, int k, unsigned mask) {
  for (int off = k >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(mask, *t, off);
    const int orow = __shfl_xor_sync(mask, *row, off);
    if (ot < *t || (ot == *t && orow < *row)) {
      *t = ot;
      *row = orow;
    }
  }
}

// The lanes of the calling thread's aligned team of `k` threads in its warp.
__device__ __forceinline__ unsigned team_mask(int k) {
  return k >= 32 ? 0xffffffffu : ((1u << k) - 1u) << ((threadIdx.x & 31) & ~(k - 1));
}

// Returns fn<K>(...) for the team size `team` (K = 1, 2, 4, 8, 16 or 32),
// else cudaErrorInvalidValue: the launch dispatch of the team kernels.
#define PT_TEAM_LAUNCH(fn, team, ...)      \
  switch (team) {                          \
    case 1: return fn<1>(__VA_ARGS__);     \
    case 2: return fn<2>(__VA_ARGS__);     \
    case 4: return fn<4>(__VA_ARGS__);     \
    case 8: return fn<8>(__VA_ARGS__);     \
    case 16: return fn<16>(__VA_ARGS__);   \
    case 32: return fn<32>(__VA_ARGS__);   \
    default: return cudaErrorInvalidValue; \
  }

constexpr int kNone = 0x7fffffff;  // no row, no box: above every real id
constexpr int kCheck = 4;          // rows a thread tests between two votes (vote)

// Does any row r of [r0, r1) pass hit(r)? Thread `part` of the team of K
// (`mask`: its team_mask) tests rows r0 + part, r0 + part + K, ..., and the
// team votes every kCheck rows a thread; it stops at the first vote that
// finds a hit and tests no row past r1. Every thread of the team must call
// it.
template <int K, typename Hit>
__device__ __forceinline__ bool vote(int r0, int r1, int part, unsigned mask, Hit hit) {
  for (int b = r0; b < r1; b += kCheck * K) {
    bool mine = false;
#pragma unroll
    for (int c = 0; c < kCheck; ++c) {
      const int r = b + c * K + part;
      if (!mine && r < r1) mine = hit(r);
    }
    if (__any_sync(mask, mine)) return true;
  }
  return false;
}

// The team successor scan of a nearest-first walk: the entered box after
// (*e, *c) in ascending (entry, id) order among boxes 0 .. n - 1, where
// entry(b) is box b's entry distance (+inf or NaN: not entered). Thread
// `part` of the team of K scans boxes part, part + K, ..., then group_min
// over `mask`; sets (*e, *c) to the box and returns true, or returns false
// (*c = kNone) when there is none. Every thread of the team must call it.
template <int K, typename Entry>
__device__ __forceinline__ bool next_box(int n, int part, unsigned mask, Entry entry, float* e,
                                         int* c) {
  const float last_e = *e;
  const int last_c = *c;
  float best_e = INFINITY;
  int best_c = kNone;
  for (int b = part; b < n; b += K) {
    const float eb = entry(b);
    if (!(eb < INFINITY)) continue;  // not entered
    const bool after = eb > last_e || (eb == last_e && b > last_c);
    if (after && eb < best_e) {  // ids ascend: the first of equal entries wins
      best_e = eb;
      best_c = b;
    }
  }
  group_min(&best_e, &best_c, K, mask);
  *e = best_e;
  *c = best_c;
  return best_c != kNone;
}

// One sphere row (center and k = |c|^2 - r^2), with od = o.d and oo = o.o:
// the near root if it is >= eps, else the far one. NaN on a miss and on a
// padding row (k = NaN), so every compare with it fails (twin:
// ops/shade.py::_sphere_ts). A negative or NaN discriminant returns NaN
// before the square root, where sqrtf would give NaN anyway: a miss, the
// common case of a sweep, skips the correctly rounded sqrtf, the costliest
// step of the test.
__device__ __forceinline__ float sphere_root(float4 s, V3 o, V3 d, float od, float oo,
                                             float eps) {
  float cd = s.x * d.x + s.y * d.y + s.z * d.z;
  float co = s.x * o.x + s.y * o.y + s.z * o.z;
  float half_b = od - cd;
  float c = oo - 2.0f * co + s.w;
  float disc = half_b * half_b - c;
  if (!(disc >= 0.0f)) return NAN;
  float sq = sqrtf(disc);
  float root1 = -half_b - sq;
  return root1 >= eps ? root1 : -half_b + sq;
}

// The same on a table row holding center and k in its first four floats.
__device__ __forceinline__ float sphere_root(const float* row, V3 o, V3 d, float od, float oo,
                                             float eps) {
  return sphere_root(make_float4(row[0], row[1], row[2], row[3]), o, d, od, oo, eps);
}

// Reciprocal of a direction component, |c| clamped up to 1e-20.
__device__ __forceinline__ float safe_inv(float c) {
  return 1.0f / (fabsf(c) < 1e-20f ? 1e-20f : c);
}

// Entry distance into one AABB row (min in its first three floats, max in
// the next three) over [t_min, t_up]; +inf when the segment misses it or the
// box is inverted (an empty padding box).
__device__ __forceinline__ float box_entry(const float* __restrict__ box, V3 o, V3 inv,
                                           float t_min, float t_up) {
  const float mnx = box[0], mny = box[1], mnz = box[2];
  const float mxx = box[3], mxy = box[4], mxz = box[5];
  if (!(mnx <= mxx)) return INFINITY;
  const float ax = (mnx - o.x) * inv.x, bx = (mxx - o.x) * inv.x;
  const float ay = (mny - o.y) * inv.y, by = (mxy - o.y) * inv.y;
  const float az = (mnz - o.z) * inv.z, bz = (mxz - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fmaxf(fminf(az, bz), t_min));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fminf(fmaxf(az, bz), t_up));
  return tn <= tf ? tn : INFINITY;
}

// A ray of the mesh walks: origin, direction, the direction's reciprocal
// (safe_inv, for box_entry) and the range [t_min, t_max].
struct Ray {
  V3 o, d, inv;
  float t_min, t_max;
};

// Ray i of (N, 3) origins and directions and (N,) ranges.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        const float* __restrict__ t_min,
                                        const float* __restrict__ t_max, int i) {
  Ray r;
  r.o = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  r.d = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  r.inv = v3(safe_inv(r.d.x), safe_inv(r.d.y), safe_inv(r.d.z));
  r.t_min = t_min[i];
  r.t_max = t_max[i];
  return r;
}

}  // namespace pt
