// One full path vertex per lane: the pool's bounce kernel.
//
// Replaces pathtrace_tpu/ops/pallas_shade.py :: _fused_bounce_kernel
// (wrapper fused_bounce), VPU sphere form, in its three modes: split shadow
// (the default), raygen (which the pool's fused branch runs) and the fused
// shadow sweep (fuse_shadow), each an instance of the kernel template
// (kRaygen, kFuseShadow), so the default instance carries none of the
// others' code.
// Plain-torch twin and the layout contract:
// pathtrace_tpu_torch/ops/shade.py :: fused_bounce_reference.
//
// Material lanes: Lambert, GGX mirror and emissive always; Oren-Nayar and
// PBR (the JAX has_on/has_pbr lanes, _eval_oren_nayar3, _eval_pbr3 and
// _sample_pbr3) when the scene's flags set has_on/has_pbr, which the
// wrapper passes as it passes the light-class flags. The JAX kernel
// evaluates every enabled lane on every lane of a tile and selects by kind;
// here a thread branches on its own material kind at run time, so a lane
// pays only for its own lobe; the twin evaluates the enabled lanes and
// selects, which gives the same values.
//
// What bounds it on the H100: the closest-hit sweep over the sphere and
// triangle rows (up to 512 spheres x ~20 flops plus ~64 triangles x ~40 per
// lane), then a few hundred flops of shading. Device traffic is ~260 bytes a
// lane, negligible next to that. Each row is a dependent chain of ~40
// instructions (no contracted multiply-adds, a correctly rounded sqrtf), so
// with one thread per lane the pool's 16,384 lanes fill only ~4 warps an SM
// and the sweep is a latency chain, not arithmetic.
//
// Design: a group of `split` threads (T, a power of two up to 16, chosen
// by the host from the row count: kernels/binding.py :: sweep_split) shares one
// lane's sweep; thread j of the group tests rows j, j+T, j+2T, ..., which
// gives 4-64 warps an SM for the latency to hide behind. Each row's t comes
// from the same arithmetic whichever thread computes it, and the group's
// bests are combined as a lexicographic min over (t, row) from (inf, 0) by
// warp shuffles: the twin's strict first-minimum argmin exactly (ties to the
// lower row, row 0 when nothing is hit). Triangles first, then spheres
// against t <= the triangles' best, as before. The winners go to shared
// memory, and one thread per lane (`lanes` threads a block, whole warps)
// shades: the shading below is the single-thread code line for line.
// Only the sweep's columns are staged in shared memory (center and k of a
// sphere as one float4, v0/e1/e2 of a triangle at a stride of 9 floats, so
// the T rows a warp reads at once sit in distinct banks and lanes reading the
// same row share a broadcast), with the light table; the winner's material,
// 1/r and normal are read once per lane from device memory. A row whose
// discriminant is negative or NaN (a miss, or a padding row) skips the square
// root (geom.cuh :: sphere_root). Blocks are lanes x T threads: 128 lanes at
// T = 1, 64 at T = 2, 32 from T = 4 up (128-512 threads).
// The host gives each thread at most ~128 rows (T = 4 for the 496 rows of
// many_spheres, 1 up to 128 rows): the shading, still one thread a lane and
// ~4 warps an SM, now sets a floor of ~0.02-0.03 ms at 16,384 lanes, and
// larger blocks (fewer resident at once) only add waves.
//
// Raygen mode (kRaygen; the pool's fused branch): the ray state comes in as
// it was before the pool's refill, with each lane's `started` flag, its
// pixel (px, py; py flipped) and the camera row [origin, lower_left, w-1,
// h-1] / [horizontal, vertical, 0, 0]. A started lane's ray is its jittered
// primary ray (uniform slots 7-8): u = (px + jx) / (w-1), v likewise, the
// direction lower_left + horizontal u + vertical v - origin normalised, with
// the op sequence of models/camera.py :: Camera.generate_rays, and its eta,
// pdf_prev and prefix are reset to 1. Every thread of the lane's group
// computes the ray itself (lane_ray, ~20 flops and a square root), so the
// sweep needs no staging; a lane that does not live on keeps the merged ray.
//
// Fused shadow mode (kFuseShadow): after shading, the live lanes' NEE shadow
// rays (the shadow_d / shadow_tmax the default exports, from the hit point)
// are swept here, on the rows already staged, by the same groups of `split`
// threads with csrc/shadow_any_hit.cu's test and vote (shadow_sweep): each
// shading thread stages its lane's ray, a barrier, each group tests rows
// j, j+T, ... and votes every kCheck rows a thread, stopping at the first
// hit, its first thread stages the verdict, a second barrier. The verdict
// zeroes the direct light, prefix * direct is added into rad on live lanes
// (the JAX order: rad + gain), and nee_gain is written as zeros; shadow_d
// and shadow_tmax are written as in the default mode. Lanes that do not live
// on pass no query: their verdict is never read. The barriers are reached
// from three places (threads with no lane to shade leave early), so they are
// the unaligned barrier.sync, which waits for every thread of the block
// whatever its path.
//
// TPU workarounds of the JAX kernel not carried over: the bf16x3 one-hot
// MXU row select is an indexed load, the MXU quadratic-
// form sphere tables are not used, and there is no ray_tile lane padding.
//
// Rounding: built with -fmad=false and without fast math, the arithmetic
// matches the twin operation for operation (IEEE division and sqrt), except
// cos/sin/atan2, which are the same CUDA math functions torch's own kernels
// call on the card. The raygen prologue therefore gives torch's
// generate_rays and its merges bit for bit, and the fused sweep the split
// shadow_any_hit's verdicts.
// NaN sphere padding rows (k = NaN) rely on NaN failing every compare,
// which fast math would break.
//
// Float64, the reference's precision: the kernel and its helpers are
// templates on the float type F; pt_fused_bounce_f64 is the same code in
// double (the JAX kernel's VPU form, which the JAX pool runs for float64
// scenes), with the double libdevice sqrt/cos/sin/atan2, constants rounded
// from double into F and eps passed as a double. The staged rows, the light
// table and the lane winners' t take twice the bytes (<= ~41 KB a block at
// the size caps); the H100 runs FP64 at half its FP32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "geom.cuh"

namespace pt {
namespace {

constexpr int kMaxThreads = 512;  // lanes x split threads a block
constexpr int kSphCols = 15;
constexpr int kTriCols = 22;
constexpr int kLgtCols = 18;
constexpr int kTriUse = 9;        // v0, e1, e2: the triangle columns the sweep reads
constexpr int kShadowUse = 7;     // a staged shadow ray: origin, direction, t_max
// Table columns (ops/shade.py).
constexpr int kTcN = 9, kTcKind = 12;
constexpr int kScInvR = 4, kScKind = 5;
constexpr int kLcIsTri = 0, kLcP = 1, kLcRad = 4, kLcE1 = 4, kLcE2 = 7, kLcN = 10,
              kLcArea = 13, kLcEmi = 14, kLcPrim = 17;
constexpr int kKindEmissive = 1, kKindMirror = 2, kKindOrenNayar = 3, kKindPbr = 4;
constexpr int kRrMinDepth = 4, kRrMaxDepth = 50;


template <typename F>
struct Params {
  const bool* busy;
  const int* bounce;
  const F* o;
  const F* d;
  const F* eta;
  const F* pdf_prev;
  const F* prefix;
  const F* u;
  const bool* started;  // raygen mode: the refilled lanes, their pixel, the camera row
  const int* px;
  const int* py;
  const F* cam;
  const F* sph;
  const F* tri;
  const F* lgt;
  F* rad;
  F* next_o;
  F* next_d;
  F* next_eta;
  F* next_pdf;
  F* next_prefix;
  bool* live;
  bool* shade;
  F* nee_gain;
  F* shadow_d;
  F* shadow_tmax;
  int S, n_sph, n_tri, n_lgt;
  int split, lanes;  // threads sharing a lane's sweep; lanes a block
  int num_tris, num_lights, max_bounces;
  int use_mis, use_nee, has_tri_l, has_sph_l, has_on, has_pbr;
  F eps;
};

template <typename F>
struct Mat {
  int kind;
  Vec3<F> col, emi;
  F rough, metal, ior;
};

template <typename F>
__device__ __forceinline__ void tangent_frame(Vec3<F> n, Vec3<F>* t, Vec3<F>* b) {
  bool ny_big = abs_(n.y) > F(0.999);
  Vec3<F> up = v3(ny_big ? F(1) : F(0), ny_big ? F(0) : F(1), F(0));
  *t = normalize3(cross3(up, n));
  *b = cross3(n, *t);
}

template <typename F>
__device__ __forceinline__ F ggx_d(F alpha2, F n_dot_h) {
  F c = clamp_max(abs_(n_dot_h), F(1));
  F denom = alpha2 * c * c + (F(1) - c) * (F(1) + c);
  return alpha2 / (F(kPi) * denom * denom);
}

template <typename F>
__device__ __forceinline__ F smith_g1(F alpha2, F cos_theta) {
  F term = sqrt_(alpha2 + (F(1) - alpha2) * cos_theta * cos_theta);
  F g = F(2) * cos_theta / (cos_theta + term);
  return cos_theta > F(0) ? g : F(0);
}

template <typename F>
__device__ __forceinline__ F smith_lambda(F alpha2, F c) {
  F num = sqrt_(alpha2 + (F(1) - alpha2) * c * c);
  return (num - c) / (F(2) * c);
}

template <typename F>
__device__ __forceinline__ F smith_g2(F alpha2, F cos_i, F cos_o) {
  F g = F(1) / (F(1) + smith_lambda(alpha2, cos_i) + smith_lambda(alpha2, cos_o));
  return (cos_i > F(0) && cos_o > F(0)) ? g : F(0);
}

template <typename F>
__device__ __forceinline__ F pow5(F x) {
  F x2 = x * x;
  return x2 * x2 * x;
}

template <typename F>
__device__ __forceinline__ Vec3<F> fresnel3(Vec3<F> color, F metallic, F ior, F cos_theta) {
  F r = (F(1) - ior) / (F(1) + ior);
  F f0d = r * r;
  F p5 = pow5(F(1) - cos_theta);
  F f0x = f0d * (F(1) - metallic) + color.x * metallic;
  F f0y = f0d * (F(1) - metallic) + color.y * metallic;
  F f0z = f0d * (F(1) - metallic) + color.z * metallic;
  return v3(f0x + (F(1) - f0x) * p5, f0y + (F(1) - f0y) * p5, f0z + (F(1) - f0z) * p5);
}

// GGX mirror bsdf and pdf toward o (reflection or transmission).
template <typename F>
__device__ void eval_mirror(const Mat<F>& m, Vec3<F> i, Vec3<F> o, Vec3<F> normal, F eta,
                            Vec3<F>* bsdf, F* pdf) {
  F alpha = m.rough * m.rough;
  F alpha2 = alpha * alpha;
  F i_dot_n = dot3(i, normal);
  F o_dot_n = dot3(o, normal);
  bool is_reflection = i_dot_n * o_dot_n > F(0);

  Vec3<F> h_r = normalize3(add3(i, o));
  F n_h_r = dot3(normal, h_r);
  F d_r = ggx_d(alpha2, n_h_r);
  F i_n_r = clamp_min(i_dot_n, F(0));
  F o_n_r = clamp_min(o_dot_n, F(0));
  F g_r = smith_g2(alpha2, i_n_r, o_n_r);
  F cos_f = clamp_min(dot3(i, h_r), F(0));
  Vec3<F> f_r = fresnel3(m.col, m.metal, m.ior, cos_f);
  F spec = d_r * g_r / (F(4) * i_n_r * o_n_r);
  Vec3<F> brdf = scale3(f_r, spec);
  F i_h_r = abs_(dot3(i, h_r));
  F pdf_r = d_r * abs_(n_h_r) / (F(4) * i_h_r);

  Vec3<F> h_t = neg3(normalize3(add3(scale3(i, eta), o)));
  F n_h_t = dot3(normal, h_t);
  F d_t = ggx_d(alpha2, n_h_t);
  F i_n_t = abs_(i_dot_n);
  F o_n_t = abs_(o_dot_n);
  F g_t = smith_g2(alpha2, i_n_t, o_n_t);
  F i_h_t = dot3(i, h_t);
  F o_h_t = dot3(o, h_t);
  F denom_t = eta * i_h_t + o_h_t;
  Vec3<F> f_t = fresnel3(m.col, m.metal, m.ior, abs_(i_h_t));
  F tt = d_t * g_t * abs_(i_h_t) * abs_(o_h_t) / (i_n_t * o_n_t * denom_t * denom_t);
  Vec3<F> btdf = v3((F(1) - f_t.x) * tt, (F(1) - f_t.y) * tt, (F(1) - f_t.z) * tt);
  F jac_t = abs_(o_h_t) / (denom_t * denom_t);
  F pdf_t = d_t * abs_(n_h_t) * jac_t;

  Vec3<F> b = is_reflection ? brdf : btdf;
  F p = is_reflection ? pdf_r : pdf_t;
  if (m.metal > F(0.99) && !is_reflection) {
    F z = F(0) * p;
    b = v3(z, z, z);
    p = F(1);
  }
  *bsdf = b;
  *pdf = p;
}

// Heitz VNDF half-vector sample.
template <typename F>
__device__ Vec3<F> sample_vndf(Vec3<F> view, Vec3<F> normal, F rough, F r1, F r2) {
  F alpha = rough * rough;
  Vec3<F> tangent, bitangent;
  tangent_frame(normal, &tangent, &bitangent);
  Vec3<F> vh = normalize3(v3(alpha * dot3(view, tangent), alpha * dot3(view, bitangent),
                        dot3(view, normal)));
  F lensq = vh.x * vh.x + vh.y * vh.y;
  F inv = F(1) / sqrt_(clamp_min(lensq, F(1e-38)));
  bool has = lensq > F(0);
  Vec3<F> t1 = v3(has ? -vh.y * inv : F(1), has ? vh.x * inv : F(0), F(0));
  Vec3<F> t2 = cross3(vh, t1);

  F r = sqrt_(r1);
  F phi = F(2.0 * kPi) * r2;
  F t1c = r * cos_(phi);
  F t2c = r * sin_(phi);
  F s = F(0.5) * (F(1) + vh.z);
  t2c = (F(1) - s) * sqrt_(clamp_min(F(1) - t1c * t1c, F(0))) + s * t2c;

  F z = sqrt_(clamp_min(F(1) - t1c * t1c - t2c * t2c, F(0)));
  Vec3<F> nh = add3(add3(scale3(t1, t1c), scale3(t2, t2c)), scale3(vh, z));
  Vec3<F> ne = normalize3(v3(alpha * nh.x, alpha * nh.y, clamp_min(nh.z, F(0))));
  return normalize3(
      add3(add3(scale3(tangent, ne.x), scale3(bitangent, ne.y)), scale3(normal, ne.z)));
}

template <typename F>
__device__ Vec3<F> cosine_hemisphere(Vec3<F> normal, F r1, F r2) {
  F phi = F(2.0 * kPi) * r1;
  F cos_theta = sqrt_(r2);
  F sin_theta = sqrt_(F(1) - cos_theta * cos_theta);
  F x = sin_theta * cos_(phi);
  F y = sin_theta * sin_(phi);
  Vec3<F> tangent, bitangent;
  tangent_frame(normal, &tangent, &bitangent);
  return normalize3(add3(add3(scale3(tangent, x), scale3(bitangent, y)),
                         scale3(normal, cos_theta)));
}

// GGX mirror sample: VNDF half vector, Fresnel coin, both branches.
template <typename F>
__device__ void sample_mirror(const Mat<F>& m, Vec3<F> i, Vec3<F> normal, F eta, F r1, F r2,
                              F u_coin, Vec3<F>* o_out, Vec3<F>* bsdf_out, F* pdf_out,
                              F* cos_out) {
  F alpha = m.rough * m.rough;
  F alpha2 = alpha * alpha;
  F i_dot_n = dot3(i, normal);

  Vec3<F> h = sample_vndf(i, normal, m.rough, r1, r2);
  F i_h = dot3(i, h);
  bool fail = i_h <= F(0);

  Vec3<F> fres = fresnel3(m.col, m.metal, m.ior, i_h);
  F sin2_i = (F(1) - i_h) * (F(1) + i_h);
  F cos2_t = F(1) - (eta * eta) * sin2_i;
  bool total_reflection = cos2_t < F(0);

  bool force_reflect = total_reflection || (m.metal > F(0.99));
  F rr_f = force_reflect ? F(1) : fres.x;
  if (force_reflect) fres = v3(F(1), F(1), F(1));
  bool is_reflect = u_coin < rr_f;

  F n_h = dot3(normal, h);
  F d = ggx_d(alpha2, n_h);

  Vec3<F> o_r = normalize3(sub3(scale3(h, F(2) * i_h), i));
  F o_n_r = clamp_min(dot3(normal, o_r), F(0));
  F i_n_r = clamp_min(i_dot_n, F(0));
  F g_r = smith_g2(alpha2, i_n_r, o_n_r);
  F spec = d * g_r / (F(4) * i_n_r * o_n_r * rr_f);
  Vec3<F> brdf = scale3(fres, spec);
  F pdf_vndf_r = smith_g1(alpha2, i_n_r) * d * clamp_min(i_h, F(0)) / i_n_r;
  F pdf_r = pdf_vndf_r / (F(4) * abs_(i_h));

  F cos_t = sqrt_(clamp_min(cos2_t, F(0)));
  Vec3<F> o_t = normalize3(sub3(scale3(h, eta * i_h - cos_t), scale3(i, eta)));
  F o_h_t = dot3(o_t, h);
  F o_n_t = abs_(dot3(normal, o_t));
  F i_n_t = abs_(i_dot_n);
  F denom_t = eta * i_h + o_h_t;
  F g_t = smith_g2(alpha2, i_n_t, o_n_t);
  F tt = d * g_t * abs_(i_h) * abs_(o_h_t) /
             (i_n_t * o_n_t * denom_t * denom_t * (F(1) - rr_f));
  Vec3<F> btdf = v3((F(1) - fres.x) * tt, (F(1) - fres.y) * tt, (F(1) - fres.z) * tt);
  F jac = abs_(o_h_t) / (denom_t * denom_t);
  F pdf_vndf_t = smith_g1(alpha2, i_n_t) * d * clamp_min(i_h, F(0)) / i_n_t;
  F pdf_t = pdf_vndf_t * jac;

  Vec3<F> o = is_reflect ? o_r : o_t;
  Vec3<F> bsdf = is_reflect ? brdf : btdf;
  F pdf = is_reflect ? pdf_r : pdf_t;
  F cs = is_reflect ? o_n_r : o_n_t;

  bool bad = fail || !finite3(bsdf) || !finite1(pdf) || (pdf <= F(0));
  if (bad) {
    F z = F(0) * pdf;
    o = normal;
    bsdf = v3(z, z, z);
    pdf = F(1);
    cs = F(0);
  }
  *o_out = o;
  *bsdf_out = bsdf;
  *pdf_out = pdf;
  *cos_out = cs;
}

// Oren-Nayar bsdf and pdf toward o (pallas_shade.py :: _eval_oren_nayar3).
template <typename F>
__device__ void eval_oren_nayar(Vec3<F> color, F rough, Vec3<F> i, Vec3<F> o, Vec3<F> normal,
                                Vec3<F>* bsdf, F* pdf) {
  F sigma2 = rough * rough;
  F a = F(1) - F(0.5) * sigma2 / (sigma2 + F(0.33));
  F b = F(0.45) * sigma2 / (sigma2 + F(0.09));

  F cos_i = clamp_min(dot3(i, normal), F(0));
  F cos_o = clamp_min(dot3(o, normal), F(0));
  F sin_i = sqrt_(clamp_min(F(1) - cos_i * cos_i, F(0)));
  F sin_o = sqrt_(clamp_min(F(1) - cos_o * cos_o, F(0)));

  Vec3<F> tangent, bitangent;
  tangent_frame(normal, &tangent, &bitangent);
  F phi_i = atan2_(dot3(i, bitangent), dot3(i, tangent));
  F phi_o = atan2_(dot3(o, bitangent), dot3(o, tangent));
  F cos_phi_diff = clamp_min(cos_(phi_i - phi_o), F(0));

  // alpha = the larger angle, beta = the smaller, by the cosine comparison.
  bool i_steeper = cos_i > cos_o;
  F tan_beta = i_steeper ? (cos_i > F(1e-6) ? sin_i / clamp_min(cos_i, F(1e-6)) : F(0))
                             : (cos_o > F(1e-6) ? sin_o / clamp_min(cos_o, F(1e-6)) : F(0));
  F sin_alpha = i_steeper ? sin_o : sin_i;

  F term = (a + b * cos_phi_diff * sin_alpha * tan_beta) / F(kPi);
  *bsdf = scale3(color, term);
  *pdf = cos_o / F(kPi);
}

// PBR bsdf and pdf toward o: GGX specular reflection plus Oren-Nayar diffuse
// scaled by kd, the pdf a Fresnel-weighted blend (pallas_shade.py ::
// _eval_pbr3).
template <typename F>
__device__ void eval_pbr(const Mat<F>& m, Vec3<F> i, Vec3<F> o, Vec3<F> normal, Vec3<F>* bsdf,
                         F* pdf) {
  F alpha = m.rough * m.rough;
  F alpha2 = alpha * alpha;

  Vec3<F> h = normalize3(add3(i, o));
  F n_h = dot3(normal, h);
  F d_ggx = ggx_d(alpha2, n_h);
  F cos_i = clamp_min(dot3(i, normal), F(0));
  F cos_o = clamp_min(dot3(o, normal), F(0));
  F g2 = smith_g2(alpha2, cos_i, cos_o);
  F cos_f = clamp_min(dot3(i, h), F(0));
  Vec3<F> f = fresnel3(m.col, m.metal, m.ior, cos_f);
  Vec3<F> spec_brdf = scale3(f, d_ggx * g2 / (F(4) * cos_i * cos_o));
  F spec_pdf = d_ggx * abs_(n_h) / (F(4) * abs_(dot3(i, h)));

  // Diffuse: Oren-Nayar x kd; metals do not diffuse.
  Vec3<F> diff_raw;
  F diff_pdf;
  eval_oren_nayar(m.col, m.rough, i, o, normal, &diff_raw, &diff_pdf);
  bool not_metal = m.metal < F(1);
  F one_m = F(1) - m.metal;
  Vec3<F> diff_brdf = not_metal ? v3(diff_raw.x * (F(1) - f.x) * one_m,
                                diff_raw.y * (F(1) - f.y) * one_m,
                                diff_raw.z * (F(1) - f.z) * one_m)
                           : v3(F(0), F(0), F(0));

  Vec3<F> b = add3(spec_brdf, diff_brdf);
  F f_avg = (f.x + f.y + f.z) / F(3);
  F sw = f_avg;
  F dw = (F(1) - f_avg) * one_m;
  F tw = sw + dw;
  F p = tw > F(1e-6) ? (sw * spec_pdf + dw * diff_pdf) / clamp_min(tw, F(1e-6)) : spec_pdf;
  if (cos_o <= F(0) || !finite3(b) || !finite1(p)) {
    F z = F(0) * p;
    b = v3(z, z, z);
    p = F(1);
  }
  *bsdf = b;
  *pdf = p;
}

// PBR sample: a coin weighted by the approximate Fresnel picks the GGX VNDF
// reflection or the shared cosine sample d_diff, evaluated there
// (pallas_shade.py :: _sample_pbr3).
template <typename F>
__device__ void sample_pbr(const Mat<F>& m, Vec3<F> i, Vec3<F> normal, F r1, F r2, F u_coin,
                           Vec3<F> d_diff, Vec3<F>* o_out, Vec3<F>* bsdf_out, F* pdf_out,
                           F* cos_out) {
  F cos_i = clamp_min(dot3(i, normal), F(0));
  F mean_c = (m.col.x + m.col.y + m.col.z) / F(3);
  F f0s = m.metal > F(0.5) ? mean_c : F(0.04);
  F f_approx = f0s + (F(1) - f0s) * pow5(F(1) - cos_i);
  F sw = f_approx;
  F dw = (F(1) - f_approx) * (F(1) - m.metal);
  F tw = sw + dw;
  F p_spec = tw > F(1e-6) ? sw / clamp_min(tw, F(1e-6)) : F(1);
  bool use_spec = u_coin < p_spec;

  Vec3<F> h = sample_vndf(i, normal, m.rough, r1, r2);
  Vec3<F> o_spec = normalize3(sub3(scale3(h, F(2) * dot3(i, h)), i));

  Vec3<F> o = use_spec ? o_spec : d_diff;
  Vec3<F> bsdf;
  F pdf;
  eval_pbr(m, i, o, normal, &bsdf, &pdf);
  F cs = clamp_min(dot3(o, normal), F(0));

  if (!finite3(bsdf) || !finite1(pdf) || pdf <= F(0)) {
    F z = F(0) * pdf;
    o = normal;
    bsdf = v3(z, z, z);
    pdf = F(1);
    cs = F(0);
  }
  *o_out = o;
  *bsdf_out = bsdf;
  *pdf_out = pdf;
  *cos_out = cs;
}

template <typename F>
__device__ __forceinline__ Mat<F> mat_row(const F* row, bool hit) {
  // Material columns: kind | color(3) | emission(3) | roughness | metallic | ior.
  Mat<F> m;
  m.kind = static_cast<int>(hit ? row[0] : F(0));
  m.col = hit ? v3(row[1], row[2], row[3]) : v3(F(0), F(0), F(0));
  m.emi = hit ? v3(row[4], row[5], row[6]) : v3(F(0), F(0), F(0));
  m.rough = hit ? row[7] : F(0);
  m.metal = hit ? row[8] : F(0);
  m.ior = hit ? row[9] : F(0);
  return m;
}

// Lane i's ray: the carried state, or (kRaygen) for a started lane its
// jittered primary ray, as models/camera.py :: Camera.generate_rays computes
// it (each product and sum rounded on its own, IEEE division, the correctly
// rounded square root of normalize3).
template <typename F, bool kRaygen>
__device__ __forceinline__ void lane_ray(const Params<F>& p, int i, Vec3<F>* o3, Vec3<F>* d3) {
  const int S = p.S;
  if (kRaygen && p.started[i]) {
    const F* c = p.cam;  // [origin, lower_left, w-1, h-1], [horizontal, vertical, 0, 0]
    const F uu = (static_cast<F>(p.px[i]) + p.u[7 * S + i]) / c[6];
    const F vv = (static_cast<F>(p.py[i]) + p.u[8 * S + i]) / c[7];
    *o3 = v3(c[0], c[1], c[2]);
    *d3 = normalize3(v3(c[3] + c[8] * uu + c[11] * vv - c[0], c[4] + c[9] * uu + c[12] * vv - c[1],
                        c[5] + c[10] * uu + c[13] * vv - c[2]));
  } else {
    *o3 = v3(p.o[i], p.o[S + i], p.o[2 * S + i]);
    *d3 = v3(p.d[i], p.d[S + i], p.d[2 * S + i]);
  }
}

// All of a block's threads waiting for one another, whichever call site each
// reached it from (barrier.sync without .aligned).
__device__ __forceinline__ void block_barrier() { asm volatile("barrier.sync 0;" ::: "memory"); }

// The fused-shadow sweep; every thread of the block calls it exactly once.
// A thread that shades a lane (`own`) stages that lane's shadow ray so, sd
// over [eps, st] (st < eps or NaN: no query); the other threads below `lanes`
// stage no query. Then the group of `split` threads of each lane tests its
// rows as csrc/shadow_any_hit.cu does (triangles, then spheres; a vote every
// kCheck rows a thread, out at the first hit) and its first thread stages
// the verdict. Returns the calling thread's lane's verdict (false when it
// shades none).
template <typename F>
__device__ bool shadow_sweep(const Params<F>& p, const Q4<F>* s_sph, const F* s_tri, F* s_q,
                             int* s_blk, bool own, Vec3<F> so, Vec3<F> sd, F st) {
  if (threadIdx.x < p.lanes) {
    F* q = s_q + threadIdx.x * kShadowUse;
    q[0] = so.x;
    q[1] = so.y;
    q[2] = so.z;
    q[3] = sd.x;
    q[4] = sd.y;
    q[5] = sd.z;
    q[6] = own ? st : -F(1);
  }
  block_barrier();
  const int T = p.split;
  const int part = threadIdx.x & (T - 1);
  const int local = threadIdx.x / T;
  const F* q = s_q + local * kShadowUse;
  const F t_max = q[6];
  const F eps = p.eps;
  bool blocked = false;
  if (t_max >= eps) {  // the same value for the whole group
    // The group's threads within the warp (T <= 16 divides 32; groups are aligned).
    const unsigned group = ((1u << T) - 1u) << ((threadIdx.x & 31) & ~(T - 1));
    const Vec3<F> o3 = v3(q[0], q[1], q[2]);
    const Vec3<F> d3 = v3(q[3], q[4], q[5]);
    const F od = dot3(o3, d3);
    const F oo = dot3(o3, o3);
    for (int base = 0; base < p.n_tri && !blocked; base += kCheck * T) {
      bool hit = false;
#pragma unroll
      for (int c = 0; c < kCheck; ++c) {
        const int r = base + c * T + part;
        F t;
        if (!hit && r < p.n_tri) hit = hit_triangle(s_tri + r * kTriUse, o3, d3, eps, t_max, &t);
      }
      blocked = __any_sync(group, hit);
    }
    for (int base = 0; base < p.n_sph && !blocked; base += kCheck * T) {
      bool hit = false;
#pragma unroll
      for (int c = 0; c < kCheck; ++c) {
        const int r = base + c * T + part;
        if (!hit && r < p.n_sph) {
          const F t_c = sphere_root(s_sph[r], o3, d3, od, oo, eps);
          hit = t_c >= eps && t_c <= t_max;
        }
      }
      blocked = __any_sync(group, hit);
    }
  }
  if (part == 0) s_blk[local] = blocked;
  block_barrier();
  return threadIdx.x < p.lanes && s_blk[threadIdx.x] != 0;
}

template <typename F, bool kRaygen, bool kFuseShadow>
__global__ void __launch_bounds__(kMaxThreads) fused_bounce_kernel(Params<F> p) {
  extern __shared__ float4 smem4[];
  Q4<F>* s_sph = reinterpret_cast<Q4<F>*>(smem4);             // cx, cy, cz, k
  F* s_tri = reinterpret_cast<F*>(s_sph + p.n_sph);   // v0, e1, e2
  F* s_lgt = s_tri + p.n_tri * kTriUse;
  F* s_tri_t = s_lgt + p.n_lgt * kLgtCols;                // per lane of the block
  F* s_sph_t = s_tri_t + p.lanes;
  int* s_tri_arg = reinterpret_cast<int*>(s_sph_t + p.lanes);
  int* s_sph_arg = s_tri_arg + p.lanes;
  F* s_q = reinterpret_cast<F*>(s_sph_arg + p.lanes);        // kFuseShadow: the shadow rays
  int* s_blk = reinterpret_cast<int*>(s_q + p.lanes * kShadowUse);   // and their verdicts
  for (int k = threadIdx.x; k < p.n_sph; k += blockDim.x) {
    const F* row = p.sph + k * kSphCols;
    s_sph[k] = q4(row[0], row[1], row[2], row[3]);
  }
  for (int k = threadIdx.x; k < p.n_tri * kTriUse; k += blockDim.x)
    s_tri[k] = p.tri[(k / kTriUse) * kTriCols + k % kTriUse];
  for (int k = threadIdx.x; k < p.n_lgt * kLgtCols; k += blockDim.x) s_lgt[k] = p.lgt[k];
  __syncthreads();

  const int S = p.S;
  const F eps = p.eps;
  const F inf = INFINITY;

  // ---- 1. Closest hit, split: thread `part` of the lane's group tests rows
  // part, part + T, ...; lanes past S sweep lane S - 1 and write nothing, so
  // every thread of a warp reaches the shuffles.
  {
    const int T = p.split;
    const int part = threadIdx.x & (T - 1);
    const int local = threadIdx.x / T;
    const int lane = blockIdx.x * p.lanes + local;
    const int il = lane < S ? lane : S - 1;
    Vec3<F> o3, d3;
    lane_ray<F, kRaygen>(p, il, &o3, &d3);

    // Triangles (Moller-Trumbore).
    F tri_t = inf;
    int tri_arg = 0;
    for (int r = part; r < p.n_tri; r += T) {
      F t;
      F ts = hit_triangle(s_tri + r * kTriUse, o3, d3, eps, inf, &t) ? t : inf;
      if (ts < tri_t) {  // strict: the first minimum wins, like argmin
        tri_t = ts;
        tri_arg = r;
      }
    }
    group_min(&tri_t, &tri_arg, T, 0xffffffffu);

    // Spheres, against t <= the triangles' best.
    const F od = dot3(o3, d3);
    const F oo = dot3(o3, o3);
    F sph_t = inf;
    int sph_arg = 0;
#pragma unroll 4
    for (int r = part; r < p.n_sph; r += T) {
      F t_c = sphere_root(s_sph[r], o3, d3, od, oo, eps);
      F tss = (t_c >= eps && t_c <= tri_t) ? t_c : inf;
      if (tss < sph_t) {
        sph_t = tss;
        sph_arg = r;
      }
    }
    group_min(&sph_t, &sph_arg, T, 0xffffffffu);
    if (part == 0) {
      s_tri_t[local] = tri_t;
      s_tri_arg[local] = tri_arg;
      s_sph_t[local] = sph_t;
      s_sph_arg[local] = sph_arg;
    }
  }
  __syncthreads();

  // ---- 2-4. One thread per lane shades ----
  // (kFuseShadow: a thread with no lane to shade still takes its part in the
  // shadow sweep.)
  if (threadIdx.x >= p.lanes) {
    if constexpr (kFuseShadow) shadow_sweep(p, s_sph, s_tri, s_q, s_blk, false, {}, {}, F(0));
    return;
  }
  const int i = blockIdx.x * p.lanes + threadIdx.x;
  if (i >= S) {
    if constexpr (kFuseShadow) shadow_sweep(p, s_sph, s_tri, s_q, s_blk, false, {}, {}, F(0));
    return;
  }
  const F tri_t = s_tri_t[threadIdx.x];
  const int tri_arg = s_tri_arg[threadIdx.x];
  const F sph_t = s_sph_t[threadIdx.x];
  const int sph_arg = s_sph_arg[threadIdx.x];

  const bool busy = p.busy[i];
  const int bounce = p.bounce[i];
  Vec3<F> o3, d3;
  lane_ray<F, kRaygen>(p, i, &o3, &d3);
  const bool fresh = kRaygen && p.started[i];  // raygen: the refill's resets
  const F eta_in = fresh ? F(1) : p.eta[i];
  const F pdf_prev = fresh ? F(1) : p.pdf_prev[i];
  const Vec3<F> pfx =
      fresh ? v3(F(1), F(1), F(1)) : v3(p.prefix[i], p.prefix[S + i], p.prefix[2 * S + i]);
  const F ox = o3.x, oy = o3.y, oz = o3.z;
  const F dx = d3.x, dy = d3.y, dz = d3.z;

  const bool tri_hit = tri_t < inf;
  const bool sph_hit = sph_t < tri_t;  // a triangle wins a tie

  const F* trow = p.tri + tri_arg * kTriCols;
  const F* srow = p.sph + sph_arg * kSphCols;
  const F best_t = sph_hit ? sph_t : tri_t;
  const bool hit_valid = sph_hit || tri_hit;
  const F tt0 = hit_valid ? best_t : F(0);
  const Vec3<F> point = v3(ox + tt0 * dx, oy + tt0 * dy, oz + tt0 * dz);
  Vec3<F> outward;
  if (sph_hit) {
    F sir = srow[kScInvR];
    outward = v3((point.x - srow[0]) * sir, (point.y - srow[1]) * sir, (point.z - srow[2]) * sir);
  } else {
    outward = tri_hit ? v3(trow[kTcN], trow[kTcN + 1], trow[kTcN + 2]) : v3(F(0), F(0), F(0));
  }
  const int prim = sph_hit ? p.num_tris + sph_arg : (tri_hit ? tri_arg : -1);
  const Mat<F> m = sph_hit ? mat_row(srow + kScKind, true) : mat_row(trow + kTcKind, tri_hit);
  const int kind = m.kind;

  const bool front_face = dot3(d3, outward) < F(0);
  const Vec3<F> normal = front_face ? outward : neg3(outward);

  // ---- 2. Emissive terminal rules ----
  const bool emis = hit_valid && kind == kKindEmissive && dot3(m.emi, m.emi) > F(0);
  Vec3<F> emis_gain;
  if (!(p.use_mis || p.use_nee)) {  // brdf_only: lights visible at any depth
    emis_gain = m.emi;
  } else {
    F w_bsdf = F(0);
    if (p.use_mis && p.num_lights > 0) {
      // The hit primitive's light row (single light: row 0).
      const F* lrow = s_lgt;
      bool lhas = true;
      if (p.num_lights != 1) {
        lhas = false;
        for (int r = 0; r < p.n_lgt; ++r) {
          if (s_lgt[r * kLgtCols + kLcPrim] == static_cast<F>(prim)) {
            lrow = s_lgt + r * kLgtCols;
            lhas = true;
            break;
          }
        }
      }
      F lsel[kLcEmi];
      for (int k = 0; k < kLcEmi; ++k) lsel[k] = lhas ? lrow[k] : F(0);
      const bool l_is_tri = lsel[kLcIsTri] > F(0.5);
      const Vec3<F> lpv = v3(lsel[kLcP], lsel[kLcP + 1], lsel[kLcP + 2]);
      const F l_rad = lsel[kLcRad];
      const Vec3<F> l_n = v3(lsel[kLcN], lsel[kLcN + 1], lsel[kLcN + 2]);
      const F l_area = lsel[kLcArea];
      F pdf_tri = F(0), pdf_sph = F(0);
      if (p.has_tri_l) {
        Vec3<F> to_l = sub3(point, o3);
        F dist_l = sqrt_(dot3(to_l, to_l));
        F safe_dl = dist_l > F(0) ? dist_l : F(1);
        Vec3<F> ldir_l = v3(to_l.x / safe_dl, to_l.y / safe_dl, to_l.z / safe_dl);
        F cos_light = abs_(dot3(l_n, neg3(ldir_l)));
        F pdf_area = F(1) / clamp_min(l_area, F(1e-20));
        pdf_tri = cos_light > F(1e-8) ? pdf_area * (dist_l * dist_l) / clamp_min(cos_light, F(1e-8))
                                    : F(1e-8);
      }
      if (p.has_sph_l) {
        Vec3<F> to_c = sub3(lpv, o3);
        F dist_sq = dot3(to_c, to_c);
        F sin2_max = (l_rad * l_rad) / (dist_sq > F(0) ? dist_sq : F(1));
        F cos_max = sqrt_(clamp_min(F(1) - sin2_max, F(0)));
        F solid = F(2.0 * kPi) * (F(1) - cos_max);
        pdf_sph = F(1) / clamp_min(solid, F(1e-12));
      }
      F pdf_shape;
      if (p.has_tri_l && p.has_sph_l) {
        pdf_shape = l_is_tri ? pdf_tri : pdf_sph;
      } else {
        pdf_shape = p.has_tri_l ? pdf_tri : pdf_sph;
      }
      // Quirk: the bsdf-side pdf is not divided by the light count.
      w_bsdf = pdf_prev / (pdf_prev + pdf_shape);
    }
    emis_gain = bounce == 0 ? m.emi : scale3(m.emi, w_bsdf);
  }
  const F zero = F(0) * ox;
  const Vec3<F> zero3 = v3(zero, zero, zero);
  Vec3<F> rad = (busy && emis) ? forz3(mul3(pfx, emis_gain)) : zero3;

  const bool shade = busy && hit_valid && !emis && bounce < p.max_bounces;
  const Vec3<F> i3 = neg3(d3);
  F u[7];
  for (int k = 0; k < 7; ++k) u[k] = p.u[k * S + i];

  // ---- 3. NEE: light pick, sample and BSDF evaluation ----
  Vec3<F> direct, sdir;
  F stmax;
  if (p.use_nee && p.num_lights > 0) {
    const F* prow = s_lgt;
    if (p.num_lights != 1) {
      int lidx = static_cast<int>(u[0] * static_cast<F>(p.num_lights));
      lidx = lidx > p.num_lights - 1 ? p.num_lights - 1 : lidx;
      prow = s_lgt + lidx * kLgtCols;
    }
    const bool p_is_tri = prow[kLcIsTri] > F(0.5);
    const Vec3<F> p_p = v3(prow[kLcP], prow[kLcP + 1], prow[kLcP + 2]);
    const F p_rad = prow[kLcRad];
    const Vec3<F> p_e1 = v3(prow[kLcE1], prow[kLcE1 + 1], prow[kLcE1 + 2]);
    const Vec3<F> p_e2 = v3(prow[kLcE2], prow[kLcE2 + 1], prow[kLcE2 + 2]);
    const Vec3<F> p_n = v3(prow[kLcN], prow[kLcN + 1], prow[kLcN + 2]);
    const F p_area = prow[kLcArea];
    const Vec3<F> p_emi = v3(prow[kLcEmi], prow[kLcEmi + 1], prow[kLcEmi + 2]);

    Vec3<F> lp_tri = zero3, lp_sph = zero3;
    F pdf_sph = F(0);
    if (p.has_tri_l) {
      // Triangle: sqrt-warp area sample.
      F sqrt_r1 = sqrt_(u[1]);
      F wu = F(1) - sqrt_r1;
      F wv = u[2] * sqrt_r1;
      lp_tri = add3(add3(p_p, scale3(p_e1, wu)), scale3(p_e2, wv));
    }
    if (p.has_sph_l) {
      // Sphere: uniform cone direction, re-intersected.
      Vec3<F> to_c = sub3(p_p, point);
      F dist_sq = dot3(to_c, to_c);
      F rad_sq = p_rad * p_rad;
      F sin2_max = rad_sq / (dist_sq > F(0) ? dist_sq : F(1));
      F cos_max = sqrt_(clamp_min(F(1) - sin2_max, F(0)));
      F solid = F(2.0 * kPi) * (F(1) - cos_max);
      pdf_sph = F(1) / clamp_min(solid, F(1e-12));
      F cth = F(1) - u[1] + u[1] * cos_max;
      F sth = sqrt_(clamp_min(F(1) - cth * cth, F(0)));
      F phi = F(2.0 * kPi) * u[2];
      F ln_c = sqrt_(dist_sq);
      bool pos_c = ln_c > F(0);
      F safe_c = pos_c ? ln_c : F(1);
      Vec3<F> wdir = pos_c ? v3(to_c.x / safe_c, to_c.y / safe_c, to_c.z / safe_c) : to_c;
      bool wy_big = abs_(wdir.y) > F(0.999);
      Vec3<F> upv = v3(wy_big ? F(1) : F(0), wy_big ? F(0) : F(1), F(0));
      Vec3<F> uax = normalize3(cross3(upv, wdir));
      Vec3<F> vax = cross3(wdir, uax);
      Vec3<F> cone = normalize3(add3(
          add3(scale3(uax, sth * cos_(phi)), scale3(vax, sth * sin_(phi))), scale3(wdir, cth)));
      Vec3<F> ocv = neg3(to_c);
      F a_q = dot3(cone, cone);
      F hb_q = dot3(ocv, cone);
      F c_q = dist_sq - rad_sq;
      F disc_q = hb_q * hb_q - a_q * c_q;
      F t_q = (-hb_q - sqrt_(clamp_min(disc_q, F(0)))) / a_q;
      lp_sph = add3(point, scale3(cone, t_q));
    }
    Vec3<F> lpoint, lnorm;
    if (p.has_tri_l && p.has_sph_l) {
      lpoint = p_is_tri ? lp_tri : lp_sph;
      lnorm = p_is_tri ? p_n : normalize3(sub3(lp_sph, p_p));
    } else if (p.has_tri_l) {
      lpoint = lp_tri;
      lnorm = p_n;
    } else {
      lpoint = lp_sph;
      lnorm = normalize3(sub3(lp_sph, p_p));
    }

    Vec3<F> to_light = sub3(lpoint, point);
    F ldist = sqrt_(dot3(to_light, to_light));
    F safe_ld = ldist > F(0) ? ldist : F(1);
    Vec3<F> ldir = v3(to_light.x / safe_ld, to_light.y / safe_ld, to_light.z / safe_ld);

    F pdf_tri = F(0);
    if (p.has_tri_l) {
      F cos_li = abs_(dot3(lnorm, neg3(ldir)));
      F pdf_area = F(1) / clamp_min(p_area, F(1e-20));
      pdf_tri = cos_li > F(1e-8) ? pdf_area * (ldist * ldist) / clamp_min(cos_li, F(1e-8))
                                 : F(1e-8);
    }
    F ls_pdf;
    if (p.has_tri_l && p.has_sph_l) {
      ls_pdf = (p_is_tri ? pdf_tri : pdf_sph) / static_cast<F>(p.num_lights);
    } else {
      ls_pdf = (p.has_tri_l ? pdf_tri : pdf_sph) / static_cast<F>(p.num_lights);
    }

    F ldir_n = dot3(ldir, normal);
    F cos_l = abs_(ldir_n);
    Vec3<F> bsdf_l = scale3(m.col, F(1.0 / kPi));
    F pdf_l = clamp_min(ldir_n, F(0)) * F(1.0 / kPi);
    if (kind == kKindMirror) {
      eval_mirror(m, i3, ldir, normal, eta_in, &bsdf_l, &pdf_l);
    } else if (p.has_on && kind == kKindOrenNayar) {
      eval_oren_nayar(m.col, m.rough, i3, ldir, normal, &bsdf_l, &pdf_l);
    } else if (p.has_pbr && kind == kKindPbr) {
      eval_pbr(m, i3, ldir, normal, &bsdf_l, &pdf_l);
    }
    if (kind == kKindEmissive) {
      bsdf_l = zero3;
      pdf_l = F(1);
    }
    F w_nee = p.use_mis ? ls_pdf / (ls_pdf + pdf_l) : F(1);
    F cscale = cos_l / ls_pdf;
    direct = forz3(v3(w_nee * bsdf_l.x * p_emi.x * cscale, w_nee * bsdf_l.y * p_emi.y * cscale,
                      w_nee * bsdf_l.z * p_emi.z * cscale));
    sdir = ldir;
    stmax = shade ? ldist - eps : -F(1);
  } else {
    direct = zero3;
    sdir = v3(zero + F(1), zero + F(1), zero + F(1));
    stmax = zero - F(1);
  }

  // ---- 4. BSDF sample, Russian roulette, next state ----
  const F eta_s = front_face ? F(1) / m.ior : m.ior;
  const Vec3<F> d_diff = cosine_hemisphere(normal, u[3], u[4]);
  Vec3<F> o_dir = d_diff;
  Vec3<F> bsdf_s = scale3(m.col, F(1.0 / kPi));
  F pdf_s = clamp_min(dot3(d_diff, normal), F(0)) * F(1.0 / kPi);
  F cos_s = clamp_min(dot3(d_diff, normal), F(0));
  if (kind == kKindMirror) {
    sample_mirror(m, i3, normal, eta_s, u[3], u[4], u[5], &o_dir, &bsdf_s, &pdf_s, &cos_s);
  } else if (p.has_on && kind == kKindOrenNayar) {
    // The shared cosine sample: only the evaluated brdf/pdf differ.
    eval_oren_nayar(m.col, m.rough, i3, d_diff, normal, &bsdf_s, &pdf_s);
  } else if (p.has_pbr && kind == kKindPbr) {
    sample_pbr(m, i3, normal, u[3], u[4], u[5], d_diff, &o_dir, &bsdf_s, &pdf_s, &cos_s);
  }
  if (kind == kKindEmissive) {
    o_dir = normal;
    bsdf_s = zero3;
    pdf_s = F(1);
    cos_s = F(0);
  }

  const F fscale = cos_s / pdf_s;
  const Vec3<F> next_tp = mul3(pfx, scale3(bsdf_s, fscale));
  const Vec3<F> tpz = forz3(next_tp);
  const F lum = clamp_max(F(0.2126) * tpz.x + F(0.7152) * tpz.y + F(0.0722) * tpz.z, F(1));
  const int kk = bounce - kRrMinDepth > 0 ? bounce - kRrMinDepth : 0;
  const F decay = ldexp_(F(1), -kk);  // exact 2^-k
  const F rr = bounce < kRrMinDepth ? F(1) : (bounce >= kRrMaxDepth ? lum * decay : lum);
  const bool live = shade && (u[6] < rr);

  Vec3<F> dout;
  if constexpr (kFuseShadow) {
    // The live lanes' shadow rays swept here; the visibility zeroes the
    // direct light, which counts only for RR survivors.
    const bool blocked =
        shadow_sweep(p, s_sph, s_tri, s_q, s_blk, true, point, sdir, live ? stmax : -F(1));
    const bool nee = p.use_nee && p.num_lights > 0;
    const Vec3<F> dgain = forz3(mul3(pfx, nee ? forz3(blocked ? zero3 : direct) : direct));
    rad = add3(rad, live ? dgain : zero3);
    dout = zero3;
  } else {
    // Split mode: export prefix * direct; the caller applies visibility and
    // `live` (NEE counts only for RR survivors).
    dout = forz3(mul3(pfx, direct));
  }
  const Vec3<F> new_pfx = forz3(v3(next_tp.x / rr, next_tp.y / rr, next_tp.z / rr));

  const Vec3<F> no = live ? point : o3;
  const Vec3<F> nd = live ? o_dir : d3;
  const Vec3<F> np = live ? new_pfx : pfx;
  p.rad[i] = rad.x;
  p.rad[S + i] = rad.y;
  p.rad[2 * S + i] = rad.z;
  p.next_o[i] = no.x;
  p.next_o[S + i] = no.y;
  p.next_o[2 * S + i] = no.z;
  p.next_d[i] = nd.x;
  p.next_d[S + i] = nd.y;
  p.next_d[2 * S + i] = nd.z;
  p.next_eta[i] = live ? eta_s : eta_in;
  p.next_pdf[i] = live ? pdf_s : pdf_prev;
  p.next_prefix[i] = np.x;
  p.next_prefix[S + i] = np.y;
  p.next_prefix[2 * S + i] = np.z;
  p.live[i] = live;
  p.shade[i] = shade;
  p.nee_gain[i] = dout.x;
  p.nee_gain[S + i] = dout.y;
  p.nee_gain[2 * S + i] = dout.z;
  p.shadow_d[i] = sdir.x;
  p.shadow_d[S + i] = sdir.y;
  p.shadow_d[2 * S + i] = sdir.z;
  p.shadow_tmax[i] = live ? stmax : -F(1);
}


// kernels/binding.py :: shared_bytes mirrors this carve-up.
template <typename F>
int launch(const bool* busy, const int* bounce, const F* o, const F* d, const F* eta,
           const F* pdf_prev, const F* prefix, const F* u, const bool* started, const int* px,
           const int* py, const F* cam, const F* sph, int n_sph, const F* tri, int n_tri,
           const F* lgt, int n_lgt, F* rad, F* next_o, F* next_d, F* next_eta, F* next_pdf,
           F* next_prefix, bool* live, bool* shade, F* nee_gain, F* shadow_d, F* shadow_tmax,
           int S, int num_tris, int num_lights, int max_bounces, int use_mis, int use_nee,
           int has_tri_l, int has_sph_l, int has_on, int has_pbr, int raygen, int fuse_shadow,
           F eps, int split, int lanes, void* stream) {
  if (S <= 0) return 0;
  // split: a power of two up to 16; lanes: whole warps; raygen: its inputs.
  if (split < 1 || split > 16 || (split & (split - 1)) != 0 || lanes < 32 || lanes % 32 != 0 ||
      lanes * split > kMaxThreads || (raygen && (!started || !px || !py || !cam)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params<F> p{busy,      bounce,     o,          d,         eta,      pdf_prev,   prefix,
              u,         started,    px,         py,        cam,      sph,        tri,
              lgt,       rad,        next_o,     next_d,    next_eta, next_pdf,   next_prefix,
              live,      shade,      nee_gain,   shadow_d,  shadow_tmax, S,       n_sph,
              n_tri,     n_lgt,      split,      lanes,     num_tris, num_lights, max_bounces,
              use_mis,   use_nee,    has_tri_l,  has_sph_l, has_on,   has_pbr,    eps};
  // The sweep's sphere rows (Q4), triangle columns and light table, then the
  // group winners' t (F) and rows (int) of each lane; with fuse_shadow each
  // lane's shadow ray (F) and verdict (int).
  size_t smem = sizeof(Q4<F>) * static_cast<size_t>(n_sph) +
                sizeof(F) * (static_cast<size_t>(n_tri) * kTriUse +
                             static_cast<size_t>(n_lgt) * kLgtCols +
                             static_cast<size_t>(lanes) * 2) +
                sizeof(int) * static_cast<size_t>(lanes) * 2;
  if (fuse_shadow) smem += (sizeof(F) * kShadowUse + sizeof(int)) * static_cast<size_t>(lanes);
  void (*kernel)(Params<F>) = raygen ? (fuse_shadow ? fused_bounce_kernel<F, true, true>
                                                    : fused_bounce_kernel<F, true, false>)
                                      : (fuse_shadow ? fused_bounce_kernel<F, false, true>
                                                     : fused_bounce_kernel<F, false, false>);
  int grid = (S + lanes - 1) / lanes;
  kernel<<<grid, lanes * split, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pt

// The float32 and float64 instances; eps comes in the instance's type. The
// raygen inputs (started, px, py, cam) are read only when raygen is set.
extern "C" int pt_fused_bounce(
    const bool* busy, const int* bounce, const float* o, const float* d, const float* eta,
    const float* pdf_prev, const float* prefix, const float* u, const bool* started,
    const int* px, const int* py, const float* cam, const float* sph, int n_sph,
    const float* tri, int n_tri, const float* lgt, int n_lgt, float* rad, float* next_o,
    float* next_d, float* next_eta, float* next_pdf, float* next_prefix, bool* live,
    bool* shade, float* nee_gain, float* shadow_d, float* shadow_tmax, int S, int num_tris,
    int num_lights, int max_bounces, int use_mis, int use_nee, int has_tri_l, int has_sph_l,
    int has_on, int has_pbr, int raygen, int fuse_shadow, float eps, int split, int lanes,
    void* stream) {
  return pt::launch(busy, bounce, o, d, eta, pdf_prev, prefix, u, started, px, py, cam, sph,
                    n_sph, tri, n_tri, lgt, n_lgt, rad, next_o, next_d, next_eta, next_pdf,
                    next_prefix, live, shade, nee_gain, shadow_d, shadow_tmax, S, num_tris,
                    num_lights, max_bounces, use_mis, use_nee, has_tri_l, has_sph_l, has_on,
                    has_pbr, raygen, fuse_shadow, eps, split, lanes, stream);
}

extern "C" int pt_fused_bounce_f64(
    const bool* busy, const int* bounce, const double* o, const double* d, const double* eta,
    const double* pdf_prev, const double* prefix, const double* u, const bool* started,
    const int* px, const int* py, const double* cam, const double* sph, int n_sph,
    const double* tri, int n_tri, const double* lgt, int n_lgt, double* rad, double* next_o,
    double* next_d, double* next_eta, double* next_pdf, double* next_prefix, bool* live,
    bool* shade, double* nee_gain, double* shadow_d, double* shadow_tmax, int S, int num_tris,
    int num_lights, int max_bounces, int use_mis, int use_nee, int has_tri_l, int has_sph_l,
    int has_on, int has_pbr, int raygen, int fuse_shadow, double eps, int split, int lanes,
    void* stream) {
  return pt::launch(busy, bounce, o, d, eta, pdf_prev, prefix, u, started, px, py, cam, sph,
                    n_sph, tri, n_tri, lgt, n_lgt, rad, next_o, next_d, next_eta, next_pdf,
                    next_prefix, live, shade, nee_gain, shadow_d, shadow_tmax, S, num_tris,
                    num_lights, max_bounces, use_mis, use_nee, has_tri_l, has_sph_l, has_on,
                    has_pbr, raygen, fuse_shadow, eps, split, lanes, stream);
}
