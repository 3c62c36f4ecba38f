// One full path vertex per lane: the pool's bounce kernel.
//
// Replaces pathtrace_tpu/ops/pallas_shade.py :: _fused_bounce_kernel
// (wrapper fused_bounce), split-shadow mode, VPU sphere form, no raygen
// mode. Plain-torch twin and the layout contract:
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
// TPU workarounds of the JAX kernel not carried over: the bf16x3 one-hot
// MXU row select is an indexed load, the MXU quadratic-
// form sphere tables are not used, and there is no ray_tile lane padding.
//
// Rounding: built with -fmad=false and without fast math, the arithmetic
// matches the twin operation for operation (IEEE division and sqrt), except
// cosf/sinf/atan2f, which are the same CUDA math functions torch's own
// kernels call on the card.
// NaN sphere padding rows (k = NaN) rely on NaN failing every compare,
// which fast math would break.

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
// Table columns (ops/shade.py).
constexpr int kTcN = 9, kTcKind = 12;
constexpr int kScInvR = 4, kScKind = 5;
constexpr int kLcIsTri = 0, kLcP = 1, kLcRad = 4, kLcE1 = 4, kLcE2 = 7, kLcN = 10,
              kLcArea = 13, kLcEmi = 14, kLcPrim = 17;
constexpr int kKindEmissive = 1, kKindMirror = 2, kKindOrenNayar = 3, kKindPbr = 4;
constexpr int kRrMinDepth = 4, kRrMaxDepth = 50;

// Inexact constants are rounded from double, as the twin's Python floats are.
constexpr float kF_1em12 = static_cast<float>(1e-12);
constexpr float kF_1em20 = static_cast<float>(1e-20);
constexpr float kF_1em38 = static_cast<float>(1e-38);
constexpr float kF_0p99 = static_cast<float>(0.99);
constexpr float kF_0p999 = static_cast<float>(0.999);
constexpr float kF_0p2126 = static_cast<float>(0.2126);
constexpr float kF_0p7152 = static_cast<float>(0.7152);
constexpr float kF_0p0722 = static_cast<float>(0.0722);
constexpr float kF_1em6 = static_cast<float>(1e-6);
constexpr float kF_0p33 = static_cast<float>(0.33);
constexpr float kF_0p45 = static_cast<float>(0.45);
constexpr float kF_0p09 = static_cast<float>(0.09);
constexpr float kF_0p04 = static_cast<float>(0.04);

struct Params {
  const bool* busy;
  const int* bounce;
  const float* o;
  const float* d;
  const float* eta;
  const float* pdf_prev;
  const float* prefix;
  const float* u;
  const float* sph;
  const float* tri;
  const float* lgt;
  float* rad;
  float* next_o;
  float* next_d;
  float* next_eta;
  float* next_pdf;
  float* next_prefix;
  bool* live;
  bool* shade;
  float* nee_gain;
  float* shadow_d;
  float* shadow_tmax;
  int S, n_sph, n_tri, n_lgt;
  int split, lanes;  // threads sharing a lane's sweep; lanes a block
  int num_tris, num_lights, max_bounces;
  int use_mis, use_nee, has_tri_l, has_sph_l, has_on, has_pbr;
  float eps;
};

struct Mat {
  int kind;
  V3 col, emi;
  float rough, metal, ior;
};

__device__ __forceinline__ void tangent_frame(V3 n, V3* t, V3* b) {
  bool ny_big = fabsf(n.y) > kF_0p999;
  V3 up = v3(ny_big ? 1.0f : 0.0f, ny_big ? 0.0f : 1.0f, 0.0f);
  *t = normalize3(cross3(up, n));
  *b = cross3(n, *t);
}

__device__ __forceinline__ float ggx_d(float alpha2, float n_dot_h) {
  float c = clamp_max(fabsf(n_dot_h), 1.0f);
  float denom = alpha2 * c * c + (1.0f - c) * (1.0f + c);
  return alpha2 / (kPiF * denom * denom);
}

__device__ __forceinline__ float smith_g1(float alpha2, float cos_theta) {
  float term = sqrtf(alpha2 + (1.0f - alpha2) * cos_theta * cos_theta);
  float g = 2.0f * cos_theta / (cos_theta + term);
  return cos_theta > 0.0f ? g : 0.0f;
}

__device__ __forceinline__ float smith_lambda(float alpha2, float c) {
  float num = sqrtf(alpha2 + (1.0f - alpha2) * c * c);
  return (num - c) / (2.0f * c);
}

__device__ __forceinline__ float smith_g2(float alpha2, float cos_i, float cos_o) {
  float g = 1.0f / (1.0f + smith_lambda(alpha2, cos_i) + smith_lambda(alpha2, cos_o));
  return (cos_i > 0.0f && cos_o > 0.0f) ? g : 0.0f;
}

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

__device__ __forceinline__ V3 fresnel3(V3 color, float metallic, float ior, float cos_theta) {
  float r = (1.0f - ior) / (1.0f + ior);
  float f0d = r * r;
  float p5 = pow5(1.0f - cos_theta);
  float f0x = f0d * (1.0f - metallic) + color.x * metallic;
  float f0y = f0d * (1.0f - metallic) + color.y * metallic;
  float f0z = f0d * (1.0f - metallic) + color.z * metallic;
  return v3(f0x + (1.0f - f0x) * p5, f0y + (1.0f - f0y) * p5, f0z + (1.0f - f0z) * p5);
}

// GGX mirror bsdf and pdf toward o (reflection or transmission).
__device__ void eval_mirror(const Mat& m, V3 i, V3 o, V3 normal, float eta, V3* bsdf,
                            float* pdf) {
  float alpha = m.rough * m.rough;
  float alpha2 = alpha * alpha;
  float i_dot_n = dot3(i, normal);
  float o_dot_n = dot3(o, normal);
  bool is_reflection = i_dot_n * o_dot_n > 0.0f;

  V3 h_r = normalize3(add3(i, o));
  float n_h_r = dot3(normal, h_r);
  float d_r = ggx_d(alpha2, n_h_r);
  float i_n_r = clamp_min(i_dot_n, 0.0f);
  float o_n_r = clamp_min(o_dot_n, 0.0f);
  float g_r = smith_g2(alpha2, i_n_r, o_n_r);
  float cos_f = clamp_min(dot3(i, h_r), 0.0f);
  V3 f_r = fresnel3(m.col, m.metal, m.ior, cos_f);
  float spec = d_r * g_r / (4.0f * i_n_r * o_n_r);
  V3 brdf = scale3(f_r, spec);
  float i_h_r = fabsf(dot3(i, h_r));
  float pdf_r = d_r * fabsf(n_h_r) / (4.0f * i_h_r);

  V3 h_t = neg3(normalize3(add3(scale3(i, eta), o)));
  float n_h_t = dot3(normal, h_t);
  float d_t = ggx_d(alpha2, n_h_t);
  float i_n_t = fabsf(i_dot_n);
  float o_n_t = fabsf(o_dot_n);
  float g_t = smith_g2(alpha2, i_n_t, o_n_t);
  float i_h_t = dot3(i, h_t);
  float o_h_t = dot3(o, h_t);
  float denom_t = eta * i_h_t + o_h_t;
  V3 f_t = fresnel3(m.col, m.metal, m.ior, fabsf(i_h_t));
  float tt = d_t * g_t * fabsf(i_h_t) * fabsf(o_h_t) / (i_n_t * o_n_t * denom_t * denom_t);
  V3 btdf = v3((1.0f - f_t.x) * tt, (1.0f - f_t.y) * tt, (1.0f - f_t.z) * tt);
  float jac_t = fabsf(o_h_t) / (denom_t * denom_t);
  float pdf_t = d_t * fabsf(n_h_t) * jac_t;

  V3 b = is_reflection ? brdf : btdf;
  float p = is_reflection ? pdf_r : pdf_t;
  if (m.metal > kF_0p99 && !is_reflection) {
    float z = 0.0f * p;
    b = v3(z, z, z);
    p = 1.0f;
  }
  *bsdf = b;
  *pdf = p;
}

// Heitz VNDF half-vector sample.
__device__ V3 sample_vndf(V3 view, V3 normal, float rough, float r1, float r2) {
  float alpha = rough * rough;
  V3 tangent, bitangent;
  tangent_frame(normal, &tangent, &bitangent);
  V3 vh = normalize3(v3(alpha * dot3(view, tangent), alpha * dot3(view, bitangent),
                        dot3(view, normal)));
  float lensq = vh.x * vh.x + vh.y * vh.y;
  float inv = 1.0f / sqrtf(clamp_min(lensq, kF_1em38));
  bool has = lensq > 0.0f;
  V3 t1 = v3(has ? -vh.y * inv : 1.0f, has ? vh.x * inv : 0.0f, 0.0f);
  V3 t2 = cross3(vh, t1);

  float r = sqrtf(r1);
  float phi = kTwoPiF * r2;
  float t1c = r * cosf(phi);
  float t2c = r * sinf(phi);
  float s = 0.5f * (1.0f + vh.z);
  t2c = (1.0f - s) * sqrtf(clamp_min(1.0f - t1c * t1c, 0.0f)) + s * t2c;

  float z = sqrtf(clamp_min(1.0f - t1c * t1c - t2c * t2c, 0.0f));
  V3 nh = add3(add3(scale3(t1, t1c), scale3(t2, t2c)), scale3(vh, z));
  V3 ne = normalize3(v3(alpha * nh.x, alpha * nh.y, clamp_min(nh.z, 0.0f)));
  return normalize3(
      add3(add3(scale3(tangent, ne.x), scale3(bitangent, ne.y)), scale3(normal, ne.z)));
}

__device__ V3 cosine_hemisphere(V3 normal, float r1, float r2) {
  float phi = kTwoPiF * r1;
  float cos_theta = sqrtf(r2);
  float sin_theta = sqrtf(1.0f - cos_theta * cos_theta);
  float x = sin_theta * cosf(phi);
  float y = sin_theta * sinf(phi);
  V3 tangent, bitangent;
  tangent_frame(normal, &tangent, &bitangent);
  return normalize3(add3(add3(scale3(tangent, x), scale3(bitangent, y)),
                         scale3(normal, cos_theta)));
}

// GGX mirror sample: VNDF half vector, Fresnel coin, both branches.
__device__ void sample_mirror(const Mat& m, V3 i, V3 normal, float eta, float r1, float r2,
                              float u_coin, V3* o_out, V3* bsdf_out, float* pdf_out,
                              float* cos_out) {
  float alpha = m.rough * m.rough;
  float alpha2 = alpha * alpha;
  float i_dot_n = dot3(i, normal);

  V3 h = sample_vndf(i, normal, m.rough, r1, r2);
  float i_h = dot3(i, h);
  bool fail = i_h <= 0.0f;

  V3 fres = fresnel3(m.col, m.metal, m.ior, i_h);
  float sin2_i = (1.0f - i_h) * (1.0f + i_h);
  float cos2_t = 1.0f - (eta * eta) * sin2_i;
  bool total_reflection = cos2_t < 0.0f;

  bool force_reflect = total_reflection || (m.metal > kF_0p99);
  float rr_f = force_reflect ? 1.0f : fres.x;
  if (force_reflect) fres = v3(1.0f, 1.0f, 1.0f);
  bool is_reflect = u_coin < rr_f;

  float n_h = dot3(normal, h);
  float d = ggx_d(alpha2, n_h);

  V3 o_r = normalize3(sub3(scale3(h, 2.0f * i_h), i));
  float o_n_r = clamp_min(dot3(normal, o_r), 0.0f);
  float i_n_r = clamp_min(i_dot_n, 0.0f);
  float g_r = smith_g2(alpha2, i_n_r, o_n_r);
  float spec = d * g_r / (4.0f * i_n_r * o_n_r * rr_f);
  V3 brdf = scale3(fres, spec);
  float pdf_vndf_r = smith_g1(alpha2, i_n_r) * d * clamp_min(i_h, 0.0f) / i_n_r;
  float pdf_r = pdf_vndf_r / (4.0f * fabsf(i_h));

  float cos_t = sqrtf(clamp_min(cos2_t, 0.0f));
  V3 o_t = normalize3(sub3(scale3(h, eta * i_h - cos_t), scale3(i, eta)));
  float o_h_t = dot3(o_t, h);
  float o_n_t = fabsf(dot3(normal, o_t));
  float i_n_t = fabsf(i_dot_n);
  float denom_t = eta * i_h + o_h_t;
  float g_t = smith_g2(alpha2, i_n_t, o_n_t);
  float tt = d * g_t * fabsf(i_h) * fabsf(o_h_t) /
             (i_n_t * o_n_t * denom_t * denom_t * (1.0f - rr_f));
  V3 btdf = v3((1.0f - fres.x) * tt, (1.0f - fres.y) * tt, (1.0f - fres.z) * tt);
  float jac = fabsf(o_h_t) / (denom_t * denom_t);
  float pdf_vndf_t = smith_g1(alpha2, i_n_t) * d * clamp_min(i_h, 0.0f) / i_n_t;
  float pdf_t = pdf_vndf_t * jac;

  V3 o = is_reflect ? o_r : o_t;
  V3 bsdf = is_reflect ? brdf : btdf;
  float pdf = is_reflect ? pdf_r : pdf_t;
  float cs = is_reflect ? o_n_r : o_n_t;

  bool bad = fail || !finite3(bsdf) || !finite1(pdf) || (pdf <= 0.0f);
  if (bad) {
    float z = 0.0f * pdf;
    o = normal;
    bsdf = v3(z, z, z);
    pdf = 1.0f;
    cs = 0.0f;
  }
  *o_out = o;
  *bsdf_out = bsdf;
  *pdf_out = pdf;
  *cos_out = cs;
}

// Oren-Nayar bsdf and pdf toward o (pallas_shade.py :: _eval_oren_nayar3).
__device__ void eval_oren_nayar(V3 color, float rough, V3 i, V3 o, V3 normal, V3* bsdf,
                                float* pdf) {
  float sigma2 = rough * rough;
  float a = 1.0f - 0.5f * sigma2 / (sigma2 + kF_0p33);
  float b = kF_0p45 * sigma2 / (sigma2 + kF_0p09);

  float cos_i = clamp_min(dot3(i, normal), 0.0f);
  float cos_o = clamp_min(dot3(o, normal), 0.0f);
  float sin_i = sqrtf(clamp_min(1.0f - cos_i * cos_i, 0.0f));
  float sin_o = sqrtf(clamp_min(1.0f - cos_o * cos_o, 0.0f));

  V3 tangent, bitangent;
  tangent_frame(normal, &tangent, &bitangent);
  float phi_i = atan2f(dot3(i, bitangent), dot3(i, tangent));
  float phi_o = atan2f(dot3(o, bitangent), dot3(o, tangent));
  float cos_phi_diff = clamp_min(cosf(phi_i - phi_o), 0.0f);

  // alpha = the larger angle, beta = the smaller, by the cosine comparison.
  bool i_steeper = cos_i > cos_o;
  float tan_beta = i_steeper ? (cos_i > kF_1em6 ? sin_i / clamp_min(cos_i, kF_1em6) : 0.0f)
                             : (cos_o > kF_1em6 ? sin_o / clamp_min(cos_o, kF_1em6) : 0.0f);
  float sin_alpha = i_steeper ? sin_o : sin_i;

  float term = (a + b * cos_phi_diff * sin_alpha * tan_beta) / kPiF;
  *bsdf = scale3(color, term);
  *pdf = cos_o / kPiF;
}

// PBR bsdf and pdf toward o: GGX specular reflection plus Oren-Nayar diffuse
// scaled by kd, the pdf a Fresnel-weighted blend (pallas_shade.py ::
// _eval_pbr3).
__device__ void eval_pbr(const Mat& m, V3 i, V3 o, V3 normal, V3* bsdf, float* pdf) {
  float alpha = m.rough * m.rough;
  float alpha2 = alpha * alpha;

  V3 h = normalize3(add3(i, o));
  float n_h = dot3(normal, h);
  float d_ggx = ggx_d(alpha2, n_h);
  float cos_i = clamp_min(dot3(i, normal), 0.0f);
  float cos_o = clamp_min(dot3(o, normal), 0.0f);
  float g2 = smith_g2(alpha2, cos_i, cos_o);
  float cos_f = clamp_min(dot3(i, h), 0.0f);
  V3 f = fresnel3(m.col, m.metal, m.ior, cos_f);
  V3 spec_brdf = scale3(f, d_ggx * g2 / (4.0f * cos_i * cos_o));
  float spec_pdf = d_ggx * fabsf(n_h) / (4.0f * fabsf(dot3(i, h)));

  // Diffuse: Oren-Nayar x kd; metals do not diffuse.
  V3 diff_raw;
  float diff_pdf;
  eval_oren_nayar(m.col, m.rough, i, o, normal, &diff_raw, &diff_pdf);
  bool not_metal = m.metal < 1.0f;
  float one_m = 1.0f - m.metal;
  V3 diff_brdf = not_metal ? v3(diff_raw.x * (1.0f - f.x) * one_m,
                                diff_raw.y * (1.0f - f.y) * one_m,
                                diff_raw.z * (1.0f - f.z) * one_m)
                           : v3(0.0f, 0.0f, 0.0f);

  V3 b = add3(spec_brdf, diff_brdf);
  float f_avg = (f.x + f.y + f.z) / 3.0f;
  float sw = f_avg;
  float dw = (1.0f - f_avg) * one_m;
  float tw = sw + dw;
  float p = tw > kF_1em6 ? (sw * spec_pdf + dw * diff_pdf) / clamp_min(tw, kF_1em6) : spec_pdf;
  if (cos_o <= 0.0f || !finite3(b) || !finite1(p)) {
    float z = 0.0f * p;
    b = v3(z, z, z);
    p = 1.0f;
  }
  *bsdf = b;
  *pdf = p;
}

// PBR sample: a coin weighted by the approximate Fresnel picks the GGX VNDF
// reflection or the shared cosine sample d_diff, evaluated there
// (pallas_shade.py :: _sample_pbr3).
__device__ void sample_pbr(const Mat& m, V3 i, V3 normal, float r1, float r2, float u_coin,
                           V3 d_diff, V3* o_out, V3* bsdf_out, float* pdf_out, float* cos_out) {
  float cos_i = clamp_min(dot3(i, normal), 0.0f);
  float mean_c = (m.col.x + m.col.y + m.col.z) / 3.0f;
  float f0s = m.metal > 0.5f ? mean_c : kF_0p04;
  float f_approx = f0s + (1.0f - f0s) * pow5(1.0f - cos_i);
  float sw = f_approx;
  float dw = (1.0f - f_approx) * (1.0f - m.metal);
  float tw = sw + dw;
  float p_spec = tw > kF_1em6 ? sw / clamp_min(tw, kF_1em6) : 1.0f;
  bool use_spec = u_coin < p_spec;

  V3 h = sample_vndf(i, normal, m.rough, r1, r2);
  V3 o_spec = normalize3(sub3(scale3(h, 2.0f * dot3(i, h)), i));

  V3 o = use_spec ? o_spec : d_diff;
  V3 bsdf;
  float pdf;
  eval_pbr(m, i, o, normal, &bsdf, &pdf);
  float cs = clamp_min(dot3(o, normal), 0.0f);

  if (!finite3(bsdf) || !finite1(pdf) || pdf <= 0.0f) {
    float z = 0.0f * pdf;
    o = normal;
    bsdf = v3(z, z, z);
    pdf = 1.0f;
    cs = 0.0f;
  }
  *o_out = o;
  *bsdf_out = bsdf;
  *pdf_out = pdf;
  *cos_out = cs;
}

__device__ __forceinline__ Mat mat_row(const float* row, bool hit) {
  // Material columns: kind | color(3) | emission(3) | roughness | metallic | ior.
  Mat m;
  m.kind = static_cast<int>(hit ? row[0] : 0.0f);
  m.col = hit ? v3(row[1], row[2], row[3]) : v3(0.0f, 0.0f, 0.0f);
  m.emi = hit ? v3(row[4], row[5], row[6]) : v3(0.0f, 0.0f, 0.0f);
  m.rough = hit ? row[7] : 0.0f;
  m.metal = hit ? row[8] : 0.0f;
  m.ior = hit ? row[9] : 0.0f;
  return m;
}

__global__ void __launch_bounds__(kMaxThreads) fused_bounce_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float4* s_sph = smem4;                                      // cx, cy, cz, k
  float* s_tri = reinterpret_cast<float*>(s_sph + p.n_sph);   // v0, e1, e2
  float* s_lgt = s_tri + p.n_tri * kTriUse;
  float* s_tri_t = s_lgt + p.n_lgt * kLgtCols;                // per lane of the block
  float* s_sph_t = s_tri_t + p.lanes;
  int* s_tri_arg = reinterpret_cast<int*>(s_sph_t + p.lanes);
  int* s_sph_arg = s_tri_arg + p.lanes;
  for (int k = threadIdx.x; k < p.n_sph; k += blockDim.x) {
    const float* row = p.sph + k * kSphCols;
    s_sph[k] = make_float4(row[0], row[1], row[2], row[3]);
  }
  for (int k = threadIdx.x; k < p.n_tri * kTriUse; k += blockDim.x)
    s_tri[k] = p.tri[(k / kTriUse) * kTriCols + k % kTriUse];
  for (int k = threadIdx.x; k < p.n_lgt * kLgtCols; k += blockDim.x) s_lgt[k] = p.lgt[k];
  __syncthreads();

  const int S = p.S;
  const float eps = p.eps;
  const float inf = INFINITY;

  // ---- 1. Closest hit, split: thread `part` of the lane's group tests rows
  // part, part + T, ...; lanes past S sweep lane S - 1 and write nothing, so
  // every thread of a warp reaches the shuffles.
  {
    const int T = p.split;
    const int part = threadIdx.x & (T - 1);
    const int local = threadIdx.x / T;
    const int lane = blockIdx.x * p.lanes + local;
    const int il = lane < S ? lane : S - 1;
    const V3 o3 = v3(p.o[il], p.o[S + il], p.o[2 * S + il]);
    const V3 d3 = v3(p.d[il], p.d[S + il], p.d[2 * S + il]);

    // Triangles (Moller-Trumbore).
    float tri_t = inf;
    int tri_arg = 0;
    for (int r = part; r < p.n_tri; r += T) {
      float t;
      float ts = hit_triangle(s_tri + r * kTriUse, o3, d3, eps, inf, &t) ? t : inf;
      if (ts < tri_t) {  // strict: the first minimum wins, like argmin
        tri_t = ts;
        tri_arg = r;
      }
    }
    group_min(&tri_t, &tri_arg, T, 0xffffffffu);

    // Spheres, against t <= the triangles' best.
    const float od = dot3(o3, d3);
    const float oo = dot3(o3, o3);
    float sph_t = inf;
    int sph_arg = 0;
#pragma unroll 4
    for (int r = part; r < p.n_sph; r += T) {
      float t_c = sphere_root(s_sph[r], o3, d3, od, oo, eps);
      float tss = (t_c >= eps && t_c <= tri_t) ? t_c : inf;
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
  if (threadIdx.x >= p.lanes) return;
  const int i = blockIdx.x * p.lanes + threadIdx.x;
  if (i >= S) return;
  const float tri_t = s_tri_t[threadIdx.x];
  const int tri_arg = s_tri_arg[threadIdx.x];
  const float sph_t = s_sph_t[threadIdx.x];
  const int sph_arg = s_sph_arg[threadIdx.x];

  const bool busy = p.busy[i];
  const int bounce = p.bounce[i];
  const V3 o3 = v3(p.o[i], p.o[S + i], p.o[2 * S + i]);
  const V3 d3 = v3(p.d[i], p.d[S + i], p.d[2 * S + i]);
  const float eta_in = p.eta[i];
  const float pdf_prev = p.pdf_prev[i];
  const V3 pfx = v3(p.prefix[i], p.prefix[S + i], p.prefix[2 * S + i]);
  const float ox = o3.x, oy = o3.y, oz = o3.z;
  const float dx = d3.x, dy = d3.y, dz = d3.z;

  const bool tri_hit = tri_t < inf;
  const bool sph_hit = sph_t < tri_t;  // a triangle wins a tie

  const float* trow = p.tri + tri_arg * kTriCols;
  const float* srow = p.sph + sph_arg * kSphCols;
  const float best_t = sph_hit ? sph_t : tri_t;
  const bool hit_valid = sph_hit || tri_hit;
  const float tt0 = hit_valid ? best_t : 0.0f;
  const V3 point = v3(ox + tt0 * dx, oy + tt0 * dy, oz + tt0 * dz);
  V3 outward;
  if (sph_hit) {
    float sir = srow[kScInvR];
    outward = v3((point.x - srow[0]) * sir, (point.y - srow[1]) * sir, (point.z - srow[2]) * sir);
  } else {
    outward = tri_hit ? v3(trow[kTcN], trow[kTcN + 1], trow[kTcN + 2]) : v3(0.0f, 0.0f, 0.0f);
  }
  const int prim = sph_hit ? p.num_tris + sph_arg : (tri_hit ? tri_arg : -1);
  const Mat m = sph_hit ? mat_row(srow + kScKind, true) : mat_row(trow + kTcKind, tri_hit);
  const int kind = m.kind;

  const bool front_face = dot3(d3, outward) < 0.0f;
  const V3 normal = front_face ? outward : neg3(outward);

  // ---- 2. Emissive terminal rules ----
  const bool emis = hit_valid && kind == kKindEmissive && dot3(m.emi, m.emi) > 0.0f;
  V3 emis_gain;
  if (!(p.use_mis || p.use_nee)) {  // brdf_only: lights visible at any depth
    emis_gain = m.emi;
  } else {
    float w_bsdf = 0.0f;
    if (p.use_mis && p.num_lights > 0) {
      // The hit primitive's light row (single light: row 0).
      const float* lrow = s_lgt;
      bool lhas = true;
      if (p.num_lights != 1) {
        lhas = false;
        for (int r = 0; r < p.n_lgt; ++r) {
          if (s_lgt[r * kLgtCols + kLcPrim] == static_cast<float>(prim)) {
            lrow = s_lgt + r * kLgtCols;
            lhas = true;
            break;
          }
        }
      }
      float lsel[kLcEmi];
      for (int k = 0; k < kLcEmi; ++k) lsel[k] = lhas ? lrow[k] : 0.0f;
      const bool l_is_tri = lsel[kLcIsTri] > 0.5f;
      const V3 lpv = v3(lsel[kLcP], lsel[kLcP + 1], lsel[kLcP + 2]);
      const float l_rad = lsel[kLcRad];
      const V3 l_n = v3(lsel[kLcN], lsel[kLcN + 1], lsel[kLcN + 2]);
      const float l_area = lsel[kLcArea];
      float pdf_tri = 0.0f, pdf_sph = 0.0f;
      if (p.has_tri_l) {
        V3 to_l = sub3(point, o3);
        float dist_l = sqrtf(dot3(to_l, to_l));
        float safe_dl = dist_l > 0.0f ? dist_l : 1.0f;
        V3 ldir_l = v3(to_l.x / safe_dl, to_l.y / safe_dl, to_l.z / safe_dl);
        float cos_light = fabsf(dot3(l_n, neg3(ldir_l)));
        float pdf_area = 1.0f / clamp_min(l_area, kF_1em20);
        pdf_tri = cos_light > kF_1em8 ? pdf_area * (dist_l * dist_l) / clamp_min(cos_light, kF_1em8)
                                    : kF_1em8;
      }
      if (p.has_sph_l) {
        V3 to_c = sub3(lpv, o3);
        float dist_sq = dot3(to_c, to_c);
        float sin2_max = (l_rad * l_rad) / (dist_sq > 0.0f ? dist_sq : 1.0f);
        float cos_max = sqrtf(clamp_min(1.0f - sin2_max, 0.0f));
        float solid = kTwoPiF * (1.0f - cos_max);
        pdf_sph = 1.0f / clamp_min(solid, kF_1em12);
      }
      float pdf_shape;
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
  const float zero = 0.0f * ox;
  const V3 zero3 = v3(zero, zero, zero);
  V3 rad = (busy && emis) ? forz3(mul3(pfx, emis_gain)) : zero3;

  const bool shade = busy && hit_valid && !emis && bounce < p.max_bounces;
  const V3 i3 = neg3(d3);
  float u[7];
  for (int k = 0; k < 7; ++k) u[k] = p.u[k * S + i];

  // ---- 3. NEE: light pick, sample and BSDF evaluation ----
  V3 direct, sdir;
  float stmax;
  if (p.use_nee && p.num_lights > 0) {
    const float* prow = s_lgt;
    if (p.num_lights != 1) {
      int lidx = static_cast<int>(u[0] * static_cast<float>(p.num_lights));
      lidx = lidx > p.num_lights - 1 ? p.num_lights - 1 : lidx;
      prow = s_lgt + lidx * kLgtCols;
    }
    const bool p_is_tri = prow[kLcIsTri] > 0.5f;
    const V3 p_p = v3(prow[kLcP], prow[kLcP + 1], prow[kLcP + 2]);
    const float p_rad = prow[kLcRad];
    const V3 p_e1 = v3(prow[kLcE1], prow[kLcE1 + 1], prow[kLcE1 + 2]);
    const V3 p_e2 = v3(prow[kLcE2], prow[kLcE2 + 1], prow[kLcE2 + 2]);
    const V3 p_n = v3(prow[kLcN], prow[kLcN + 1], prow[kLcN + 2]);
    const float p_area = prow[kLcArea];
    const V3 p_emi = v3(prow[kLcEmi], prow[kLcEmi + 1], prow[kLcEmi + 2]);

    V3 lp_tri = zero3, lp_sph = zero3;
    float pdf_sph = 0.0f;
    if (p.has_tri_l) {
      // Triangle: sqrt-warp area sample.
      float sqrt_r1 = sqrtf(u[1]);
      float wu = 1.0f - sqrt_r1;
      float wv = u[2] * sqrt_r1;
      lp_tri = add3(add3(p_p, scale3(p_e1, wu)), scale3(p_e2, wv));
    }
    if (p.has_sph_l) {
      // Sphere: uniform cone direction, re-intersected.
      V3 to_c = sub3(p_p, point);
      float dist_sq = dot3(to_c, to_c);
      float rad_sq = p_rad * p_rad;
      float sin2_max = rad_sq / (dist_sq > 0.0f ? dist_sq : 1.0f);
      float cos_max = sqrtf(clamp_min(1.0f - sin2_max, 0.0f));
      float solid = kTwoPiF * (1.0f - cos_max);
      pdf_sph = 1.0f / clamp_min(solid, kF_1em12);
      float cth = 1.0f - u[1] + u[1] * cos_max;
      float sth = sqrtf(clamp_min(1.0f - cth * cth, 0.0f));
      float phi = kTwoPiF * u[2];
      float ln_c = sqrtf(dist_sq);
      bool pos_c = ln_c > 0.0f;
      float safe_c = pos_c ? ln_c : 1.0f;
      V3 wdir = pos_c ? v3(to_c.x / safe_c, to_c.y / safe_c, to_c.z / safe_c) : to_c;
      bool wy_big = fabsf(wdir.y) > kF_0p999;
      V3 upv = v3(wy_big ? 1.0f : 0.0f, wy_big ? 0.0f : 1.0f, 0.0f);
      V3 uax = normalize3(cross3(upv, wdir));
      V3 vax = cross3(wdir, uax);
      V3 cone = normalize3(add3(add3(scale3(uax, sth * cosf(phi)), scale3(vax, sth * sinf(phi))),
                                scale3(wdir, cth)));
      V3 ocv = neg3(to_c);
      float a_q = dot3(cone, cone);
      float hb_q = dot3(ocv, cone);
      float c_q = dist_sq - rad_sq;
      float disc_q = hb_q * hb_q - a_q * c_q;
      float t_q = (-hb_q - sqrtf(clamp_min(disc_q, 0.0f))) / a_q;
      lp_sph = add3(point, scale3(cone, t_q));
    }
    V3 lpoint, lnorm;
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

    V3 to_light = sub3(lpoint, point);
    float ldist = sqrtf(dot3(to_light, to_light));
    float safe_ld = ldist > 0.0f ? ldist : 1.0f;
    V3 ldir = v3(to_light.x / safe_ld, to_light.y / safe_ld, to_light.z / safe_ld);

    float pdf_tri = 0.0f;
    if (p.has_tri_l) {
      float cos_li = fabsf(dot3(lnorm, neg3(ldir)));
      float pdf_area = 1.0f / clamp_min(p_area, kF_1em20);
      pdf_tri = cos_li > kF_1em8 ? pdf_area * (ldist * ldist) / clamp_min(cos_li, kF_1em8) : kF_1em8;
    }
    float ls_pdf;
    if (p.has_tri_l && p.has_sph_l) {
      ls_pdf = (p_is_tri ? pdf_tri : pdf_sph) / static_cast<float>(p.num_lights);
    } else {
      ls_pdf = (p.has_tri_l ? pdf_tri : pdf_sph) / static_cast<float>(p.num_lights);
    }

    float ldir_n = dot3(ldir, normal);
    float cos_l = fabsf(ldir_n);
    V3 bsdf_l = scale3(m.col, kInvPiF);
    float pdf_l = clamp_min(ldir_n, 0.0f) * kInvPiF;
    if (kind == kKindMirror) {
      eval_mirror(m, i3, ldir, normal, eta_in, &bsdf_l, &pdf_l);
    } else if (p.has_on && kind == kKindOrenNayar) {
      eval_oren_nayar(m.col, m.rough, i3, ldir, normal, &bsdf_l, &pdf_l);
    } else if (p.has_pbr && kind == kKindPbr) {
      eval_pbr(m, i3, ldir, normal, &bsdf_l, &pdf_l);
    }
    if (kind == kKindEmissive) {
      bsdf_l = zero3;
      pdf_l = 1.0f;
    }
    float w_nee = p.use_mis ? ls_pdf / (ls_pdf + pdf_l) : 1.0f;
    float cscale = cos_l / ls_pdf;
    direct = forz3(v3(w_nee * bsdf_l.x * p_emi.x * cscale, w_nee * bsdf_l.y * p_emi.y * cscale,
                      w_nee * bsdf_l.z * p_emi.z * cscale));
    sdir = ldir;
    stmax = shade ? ldist - eps : -1.0f;
  } else {
    direct = zero3;
    sdir = v3(zero + 1.0f, zero + 1.0f, zero + 1.0f);
    stmax = zero - 1.0f;
  }

  // ---- 4. BSDF sample, Russian roulette, next state ----
  const float eta_s = front_face ? 1.0f / m.ior : m.ior;
  const V3 d_diff = cosine_hemisphere(normal, u[3], u[4]);
  V3 o_dir = d_diff;
  V3 bsdf_s = scale3(m.col, kInvPiF);
  float pdf_s = clamp_min(dot3(d_diff, normal), 0.0f) * kInvPiF;
  float cos_s = clamp_min(dot3(d_diff, normal), 0.0f);
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
    pdf_s = 1.0f;
    cos_s = 0.0f;
  }

  const float fscale = cos_s / pdf_s;
  const V3 next_tp = mul3(pfx, scale3(bsdf_s, fscale));
  const V3 tpz = forz3(next_tp);
  const float lum = clamp_max(kF_0p2126 * tpz.x + kF_0p7152 * tpz.y + kF_0p0722 * tpz.z, 1.0f);
  const int kk = bounce - kRrMinDepth > 0 ? bounce - kRrMinDepth : 0;
  const float decay = ldexpf(1.0f, -kk);  // exact 2^-k
  const float rr = bounce < kRrMinDepth ? 1.0f : (bounce >= kRrMaxDepth ? lum * decay : lum);
  const bool live = shade && (u[6] < rr);

  // Split mode: export prefix * direct; the caller applies visibility and
  // `live` (NEE counts only for RR survivors).
  const V3 dout = forz3(mul3(pfx, direct));
  const V3 new_pfx = forz3(v3(next_tp.x / rr, next_tp.y / rr, next_tp.z / rr));

  const V3 no = live ? point : o3;
  const V3 nd = live ? o_dir : d3;
  const V3 np = live ? new_pfx : pfx;
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
  p.shadow_tmax[i] = live ? stmax : -1.0f;
}

}  // namespace
}  // namespace pt

extern "C" int pt_fused_bounce(
    const bool* busy, const int* bounce, const float* o, const float* d, const float* eta,
    const float* pdf_prev, const float* prefix, const float* u, const float* sph, int n_sph,
    const float* tri, int n_tri, const float* lgt, int n_lgt, float* rad, float* next_o,
    float* next_d, float* next_eta, float* next_pdf, float* next_prefix, bool* live,
    bool* shade, float* nee_gain, float* shadow_d, float* shadow_tmax, int S, int num_tris,
    int num_lights, int max_bounces, int use_mis, int use_nee, int has_tri_l, int has_sph_l,
    int has_on, int has_pbr, float eps, int split, int lanes, void* stream) {
  if (S <= 0) return 0;
  // split: a power of two up to 16; lanes: whole warps.
  if (split < 1 || split > 16 || (split & (split - 1)) != 0 || lanes < 32 || lanes % 32 != 0 ||
      lanes * split > pt::kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  pt::Params p{busy,      bounce,     o,          d,         eta,      pdf_prev,   prefix,
               u,         sph,        tri,        lgt,       rad,      next_o,     next_d,
               next_eta,  next_pdf,   next_prefix, live,     shade,    nee_gain,   shadow_d,
               shadow_tmax, S,        n_sph,      n_tri,     n_lgt,    split,      lanes,
               num_tris,  num_lights, max_bounces, use_mis,  use_nee,  has_tri_l,  has_sph_l,
               has_on,    has_pbr,    eps};
  // kernels/binding.py :: shared_bytes mirrors this carve-up.
  size_t smem = sizeof(float4) * static_cast<size_t>(n_sph) +
                sizeof(float) * (static_cast<size_t>(n_tri) * pt::kTriUse +
                                 static_cast<size_t>(n_lgt) * pt::kLgtCols +
                                 static_cast<size_t>(lanes) * 4);
  int grid = (S + lanes - 1) / lanes;
  pt::fused_bounce_kernel<<<grid, lanes * split, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
