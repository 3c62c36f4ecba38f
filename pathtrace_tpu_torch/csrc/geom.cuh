// 3-vector helpers and the ray-primitive tests shared by the kernels.
//
// Every helper keeps the operation order of the plain-torch twins in
// ops/shade.py (sums left to right, no reassociation); the library is
// built with -fmad=false, so no multiply-add is contracted either, and a
// kernel and its twin round alike everywhere except in cos/sin/atan2, which
// are the CUDA math library's on both sides on the card.
// Max/min follow torch.clamp_min/clamp_max: a NaN operand propagates
// (fmaxf/fminf would drop it and turn a NaN the twin screens out later into
// a finite value).
#pragma once

#include <math.h>

namespace pt {

// The helpers are templates on the float type F (float or double): the
// float32 kernels instantiate them with float, and their arithmetic is the
// plain float code it was; the float64 instances use the double forms of the
// same operations. Inexact constants are rounded from double into F (F(x)),
// as the twins' Python floats are rounded into the tensors' dtype.

constexpr double kPi = 3.14159265358979323846;

template <typename F>
struct Vec3 {
  F x, y, z;
};
using V3 = Vec3<float>;

// Four F read or staged as one: a float4, or two 16-byte halves of doubles.
struct __align__(16) Double4 {
  double x, y, z, w;
};
template <typename F>
struct QuadOf;
template <>
struct QuadOf<float> {
  using type = float4;
};
template <>
struct QuadOf<double> {
  using type = Double4;
};
template <typename F>
using Q4 = typename QuadOf<F>::type;

template <typename F>
__device__ __forceinline__ Q4<F> q4(F x, F y, F z, F w) {
  return Q4<F>{x, y, z, w};
}

// The math functions by type: the f forms in float, the libdevice double
// forms in double (both correctly rounded sqrt; cos/sin/atan2 are the CUDA
// math library's, as torch's own kernels call them on the card).
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float ldexp_(float x, int k) { return ldexpf(x, k); }
__device__ __forceinline__ double ldexp_(double x, int k) { return ldexp(x, k); }

template <typename F>
__device__ __forceinline__ Vec3<F> v3(F x, F y, F z) {
  return Vec3<F>{x, y, z};
}

template <typename F>
__device__ __forceinline__ F dot3(Vec3<F> a, Vec3<F> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename F>
__device__ __forceinline__ Vec3<F> cross3(Vec3<F> a, Vec3<F> b) {
  return Vec3<F>{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <typename F>
__device__ __forceinline__ Vec3<F> add3(Vec3<F> a, Vec3<F> b) {
  return Vec3<F>{a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename F>
__device__ __forceinline__ Vec3<F> sub3(Vec3<F> a, Vec3<F> b) {
  return Vec3<F>{a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename F>
__device__ __forceinline__ Vec3<F> scale3(Vec3<F> a, F s) {
  return Vec3<F>{a.x * s, a.y * s, a.z * s};
}
template <typename F>
__device__ __forceinline__ Vec3<F> neg3(Vec3<F> a) {
  return Vec3<F>{-a.x, -a.y, -a.z};
}
template <typename F>
__device__ __forceinline__ Vec3<F> mul3(Vec3<F> a, Vec3<F> b) {
  return Vec3<F>{a.x * b.x, a.y * b.y, a.z * b.z};
}

// Components divided by the length; zero vectors pass through unchanged.
template <typename F>
__device__ __forceinline__ Vec3<F> normalize3(Vec3<F> a) {
  F ln = sqrt_(dot3(a, a));
  bool pos = ln > F(0);
  F safe = pos ? ln : F(1);
  return pos ? Vec3<F>{a.x / safe, a.y / safe, a.z / safe} : a;
}

template <typename F>
__device__ __forceinline__ bool finite1(F x) {
  return isfinite(x);
}
template <typename F>
__device__ __forceinline__ bool finite3(Vec3<F> a) {
  return finite1(a.x) && finite1(a.y) && finite1(a.z);
}
template <typename F>
__device__ __forceinline__ F forz(F x) {
  return finite1(x) ? x : F(0);
}
template <typename F>
__device__ __forceinline__ Vec3<F> forz3(Vec3<F> a) {
  return Vec3<F>{forz(a.x), forz(a.y), forz(a.z)};
}

template <typename F>
__device__ __forceinline__ F clamp_min(F x, F lo) {
  return x < lo ? lo : x;
}
template <typename F>
__device__ __forceinline__ F clamp_max(F x, F hi) {
  return x > hi ? hi : x;
}

// Moller-Trumbore against one triangle given as v0, e1, e2. Sets *t_out and
// returns whether it is a hit with t in [eps, t_max] (twin:
// ops/shade.py::_tri_hits).
template <typename F>
__device__ __forceinline__ bool hit_triangle(F v0x, F v0y, F v0z, F e1x, F e1y, F e1z, F e2x,
                                             F e2y, F e2z, Vec3<F> o, Vec3<F> d, F eps, F t_max,
                                             F* t_out) {
  F hx = d.y * e2z - d.z * e2y;
  F hy = d.z * e2x - d.x * e2z;
  F hz = d.x * e2y - d.y * e2x;
  F a = e1x * hx + e1y * hy + e1z * hz;
  F f = F(1) / a;
  F sx = o.x - v0x, sy = o.y - v0y, sz = o.z - v0z;
  F uu = f * (sx * hx + sy * hy + sz * hz);
  F qx = sy * e1z - sz * e1y;
  F qy = sz * e1x - sx * e1z;
  F qz = sx * e1y - sy * e1x;
  F vv = f * (d.x * qx + d.y * qy + d.z * qz);
  F t = f * (e2x * qx + e2y * qy + e2z * qz);
  *t_out = t;
  return abs_(a) >= F(1e-8) && uu >= F(0) && uu <= F(1) && vv >= F(0) && uu + vv <= F(1) &&
         t >= eps && t <= t_max;
}

// The same on a table row holding v0, e1, e2 in its first nine values.
template <typename F>
__device__ __forceinline__ bool hit_triangle(const F* row, Vec3<F> o, Vec3<F> d, F eps, F t_max,
                                             F* t_out) {
  return hit_triangle(row[0], row[1], row[2], row[3], row[4], row[5], row[6], row[7], row[8], o,
                      d, eps, t_max, t_out);
}

// The same on a 16-value row aligned to 16 bytes, read as three Q4 loads.
template <typename F>
__device__ __forceinline__ bool hit_triangle(const Q4<F>* row, Vec3<F> o, Vec3<F> d, F eps,
                                             F t_max, F* t_out) {
  const Q4<F> a = row[0], b = row[1], c = row[2];
  return hit_triangle(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, o, d, eps, t_max, t_out);
}

// The (t, row) lexicographic min over each aligned team of `k` threads (a
// power of two up to 32) of a warp; `mask` holds the calling thread's team
// (or more: every thread in it must make the same call). Every thread ends
// with its team's least t and, among equal t, the least row. No t may be NaN
// (a miss is inf), so this is the strict first-minimum argmin over the rows
// the team's threads kept.
template <typename F>
__device__ __forceinline__ void group_min(F* t, int* row, int k, unsigned mask) {
  for (int off = k >> 1; off > 0; off >>= 1) {
    const F ot = __shfl_xor_sync(mask, *t, off);
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
template <int K, typename Entry, typename F>
__device__ __forceinline__ bool next_box(int n, int part, unsigned mask, Entry entry, F* e,
                                         int* c) {
  const F last_e = *e;
  const int last_c = *c;
  F best_e = INFINITY;
  int best_c = kNone;
  for (int b = part; b < n; b += K) {
    const F eb = entry(b);
    if (!(eb < F(INFINITY))) continue;  // not entered
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
// before the square root, where sqrt would give NaN anyway: a miss, the
// common case of a sweep, skips the correctly rounded square root, the
// costliest step of the test.
template <typename F>
__device__ __forceinline__ F sphere_root(Q4<F> s, Vec3<F> o, Vec3<F> d, F od, F oo, F eps) {
  F cd = s.x * d.x + s.y * d.y + s.z * d.z;
  F co = s.x * o.x + s.y * o.y + s.z * o.z;
  F half_b = od - cd;
  F c = oo - F(2) * co + s.w;
  F disc = half_b * half_b - c;
  if (!(disc >= F(0))) return NAN;
  F sq = sqrt_(disc);
  F root1 = -half_b - sq;
  return root1 >= eps ? root1 : -half_b + sq;
}

// The same on a table row holding center and k in its first four values.
template <typename F>
__device__ __forceinline__ F sphere_root(const F* row, Vec3<F> o, Vec3<F> d, F od, F oo, F eps) {
  return sphere_root(q4(row[0], row[1], row[2], row[3]), o, d, od, oo, eps);
}

// The least |direction component| safe_inv divides by, by type: each its
// own literal (a double literal rounded to float need not equal 1e-20f).
template <typename F>
struct Tiny;
template <>
struct Tiny<float> {
  static constexpr float value = 1e-20f;
};
template <>
struct Tiny<double> {
  static constexpr double value = 1e-20;
};

// Reciprocal of a direction component, |c| clamped up to Tiny<F>.
template <typename F>
__device__ __forceinline__ F safe_inv(F c) {
  constexpr F tiny = Tiny<F>::value;
  return F(1) / (abs_(c) < tiny ? tiny : c);
}

// Max/min that drop a NaN operand (fmaxf/fminf, fmax/fmin): box_entry's
// slab test relies on it (a NaN t_max yields a finite entry, which every
// caller's gate then refuses).
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_(double a, double b) { return fmin(a, b); }

// Entry distance into one AABB row (min in its first three values, max in
// the next three) over [t_min, t_up]; +inf when the segment misses it or the
// box is inverted (an empty padding box).
template <typename F>
__device__ __forceinline__ F box_entry(const F* __restrict__ box, Vec3<F> o, Vec3<F> inv,
                                       F t_min, F t_up) {
  const F mnx = box[0], mny = box[1], mnz = box[2];
  const F mxx = box[3], mxy = box[4], mxz = box[5];
  if (!(mnx <= mxx)) return F(INFINITY);
  const F ax = (mnx - o.x) * inv.x, bx = (mxx - o.x) * inv.x;
  const F ay = (mny - o.y) * inv.y, by = (mxy - o.y) * inv.y;
  const F az = (mnz - o.z) * inv.z, bz = (mxz - o.z) * inv.z;
  const F tn = fmax_(fmax_(fmin_(ax, bx), fmin_(ay, by)), fmax_(fmin_(az, bz), t_min));
  const F tf = fmin_(fmin_(fmax_(ax, bx), fmax_(ay, by)), fmin_(fmax_(az, bz), t_up));
  return tn <= tf ? tn : F(INFINITY);
}

// A ray of the mesh walks: origin, direction, the direction's reciprocal
// (safe_inv, for box_entry) and the range [t_min, t_max].
template <typename F>
struct RayT {
  Vec3<F> o, d, inv;
  F t_min, t_max;
};
using Ray = RayT<float>;

// Ray i of (N, 3) origins and directions and (N,) ranges.
template <typename F>
__device__ __forceinline__ RayT<F> load_ray(const F* __restrict__ o, const F* __restrict__ d,
                                            const F* __restrict__ t_min,
                                            const F* __restrict__ t_max, int i) {
  RayT<F> r;
  r.o = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  r.d = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  r.inv = v3(safe_inv(r.d.x), safe_inv(r.d.y), safe_inv(r.d.z));
  r.t_min = t_min[i];
  r.t_max = t_max[i];
  return r;
}

}  // namespace pt
