// Device versions of the port's plain-torch densities, shared by the
// kernels that evaluate prior terms (K1 prior_terms, K5's range step, K6
// contra_step).
// Each mirrors its plain version operation by operation (ops/dists.py,
// ops/birth_death.py); build without fast math so isnan/isinf/-inf are
// exact.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace mcmcdate {

constexpr float kLnSqrt2Pi = 0.9189385332046727f;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr double kEpsNearCritical = 1e-6;
constexpr float kSqrt1_2 = 0.70710678118654752440f;

__device__ __forceinline__ float clip0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float log1pmx(float u) {
  if (fabsf(u) < 0.35f) {
    const float us = u;
    return -(us * us) *
           (0.5f - us * ((float)(1.0 / 3.0) -
                         us * (0.25f - us * (0.2f - us * ((float)(1.0 / 6.0) -
                                                          us * ((float)(1.0 / 7.0) - us / 8.0f))))));
  }
  return log1pf(u) - u;
}

__device__ __forceinline__ float gamma_logpdf(float shape, float scale, float x) {
  const bool ok = (x > 0.f) && isfinite(x) && isfinite(shape) && (shape > 0.f);
  if (!ok) return -INFINITY;
  if (shape > 1e2f) {
    const float m = shape * scale;
    const float d = x / m;
    return 0.5f * logf(shape) - kLnSqrt2Pi - logf(m) - logf(d) + shape * log1pmx(d - 1.0f) -
           1.0f / (12.0f * shape);
  }
  return (shape - 1.0f) * logf(x) - x / scale - shape * logf(scale) - lgammaf(shape);
}

__device__ __forceinline__ float gamma_mean_variance_logpdf(float mean, float variance, float x) {
  return gamma_logpdf(mean * mean / variance, variance / mean, x);
}

__device__ __forceinline__ float log_normal_mean_param_logpdf(float mean, float variance,
                                                              float x) {
  if (!((x > 0.f) && isfinite(x))) return -INFINITY;
  const float t = -(kLnSqrt2Pi + logf(x * sqrtf(variance)));
  const float b = logf(x / mean) + 0.5f * variance;
  const float e = -b * b / (2.0f * variance);
  return t + e;
}

__device__ __forceinline__ float exponential_logpdf(float rate, float x) {
  return x >= 0.f ? logf(rate) - rate * x : -INFINITY;
}

// The birth and death rates of a chain as de_factors and bd_term_local read
// them.  BdRates forms d = la - mu, 2 log|d| and log la at each use, as the
// plain version does; BdConsts (bd_consts) holds them, formed once per
// chain by the same operations, so a kernel that evaluates many rows of one
// chain saves a double log per de_factors and one per inner node, with
// every term bitwise the same.
struct BdRates {
  double la, mu;
  __device__ __forceinline__ double d() const { return la - mu; }
  __device__ __forceinline__ bool near() const { return fabs(d()) < kEpsNearCritical; }
  __device__ __forceinline__ double two_log_d() const {
    const double dd = d();
    const double d_safe = dd == 0.0 ? 1.0 : dd;
    return 2.0 * log(fabs(d_safe));
  }
  __device__ __forceinline__ double log_la() const { return log(la); }
};

struct BdConsts {
  double la, mu, d_, two_log_d_, log_la_;
  bool near_;
  __device__ __forceinline__ double d() const { return d_; }
  __device__ __forceinline__ bool near() const { return near_; }
  __device__ __forceinline__ double two_log_d() const { return two_log_d_; }
  __device__ __forceinline__ double log_la() const { return log_la_; }
};

__device__ __forceinline__ BdConsts bd_consts(double la, double mu) {
  const BdRates r{la, mu};
  return BdConsts{la, mu, r.d(), r.two_log_d(), r.log_la(), r.near()};
}

// log D and E at the top of a branch of length dt (ops/birth_death.py:19),
// in double.
template <class K>
__device__ __forceinline__ void de_factors(const K& k, double c, double dt, double* log_d,
                                           double* e) {
  const double la = k.la, mu = k.mu;
  const double d = k.d();
  if (k.near()) {
    const double y_nc = (mu - c * la) * dt;
    const double nom = 1.0 - d * dt;
    const double den = 1.0 + y_nc;
    const double den_safe = den == 0.0 ? 1.0 : den;
    *log_d = (nom > 0.0 && den != 0.0) ? log(nom) - 2.0 * log(fabs(den_safe)) : -INFINITY;
    *e = (c + y_nc) / den_safe;
    return;
  }
  const double c1 = c - 1.0;
  const double t_pos = fabs(d) * dt;
  const double z = exp(-t_pos);
  const bool pos = d > 0.0;
  const double p = pos ? la * c1 : la * c1 * z;
  const double q = pos ? (mu - c * la) * z : mu - c * la;
  const double r = pos ? mu * c1 : mu * c1 * z;
  const double denom = p + q;
  const double denom_safe = denom == 0.0 ? 1.0 : denom;
  *log_d = denom != 0.0 ? k.two_log_d() - t_pos - 2.0 * log(fabs(denom_safe)) : -INFINITY;
  *e = (r + q) / denom_safe;
}

__device__ __forceinline__ void de_factors(double la, double mu, double c, double dt,
                                           double* log_d, double* e) {
  de_factors(BdRates{la, mu}, c, dt, log_d, e);
}

// One branch's relaxed-clock term, mean 1 (clock_term_local,
// ops/local_terms.py); model ids in the order of ops/clocks.py MODELS.
__device__ __forceinline__ float clock_term_local(int model, float r, float tl, float var) {
  const float t = tl > 0.f ? tl : 1.0f;
  switch (model) {
    case 0:  // UncorrelatedGamma
      return gamma_mean_variance_logpdf(1.0f, var, r);
    case 1:  // UncorrelatedLogNormal
      return log_normal_mean_param_logpdf(1.0f, var, r);
    case 2:  // UncorrelatedWhiteNoise
      return tl > 0.f ? gamma_mean_variance_logpdf(1.0f, var / t, r) : -INFINITY;
    case 3:  // AutocorrelatedGamma
      return tl > 0.f ? gamma_mean_variance_logpdf(1.0f, var * t, r) : -INFINITY;
    default:  // AutocorrelatedLogNormal
      return tl > 0.f ? log_normal_mean_param_logpdf(1.0f, var * t, r) : -INFINITY;
  }
}

// The UncorrelatedGamma clock term (model 0) of a chain: its density's
// parameters do not depend on the branch, so the terms of gamma_logpdf
// that depend on the shape alone (log shape, lgamma) are formed once per
// chain by the same operations; clock_term_local(0, r, tl, var) is
// gamma_clock_term(gamma_clock(var), r), bitwise.
struct GammaClock {
  float shape, scale, shape_m1, shape_log_scale, lgamma_shape, m, head, tail;
  bool shape_ok;
};

__device__ __forceinline__ GammaClock gamma_clock(float var) {
  GammaClock k;
  k.shape = 1.0f * 1.0f / var;
  k.scale = var / 1.0f;
  k.shape_ok = isfinite(k.shape) && (k.shape > 0.f);
  k.shape_m1 = k.shape - 1.0f;
  k.shape_log_scale = k.shape * logf(k.scale);
  k.lgamma_shape = lgammaf(k.shape);
  k.m = k.shape * k.scale;
  k.head = 0.5f * logf(k.shape) - kLnSqrt2Pi - logf(k.m);
  k.tail = 1.0f / (12.0f * k.shape);
  return k;
}

__device__ __forceinline__ float gamma_clock_term(const GammaClock& k, float x) {
  const bool ok = (x > 0.f) && isfinite(x) && k.shape_ok;
  if (!ok) return -INFINITY;
  if (k.shape > 1e2f) {
    const float d = x / k.m;
    return k.head - logf(d) + k.shape * log1pmx(d - 1.0f) - k.tail;
  }
  return k.shape_m1 * logf(x) - x / k.scale - k.shape_log_scale - k.lgamma_shape;
}

// Birth-death term of a non-root node with rho = 1 (bd_term_local,
// ops/local_terms.py), in double and rounded once.
template <class K>
__device__ __forceinline__ float bd_term_local(double h_node, double h_parent, bool leaf,
                                               const K& k) {
  double log_d, e;
  const double dt = h_parent - h_node;
  double c = 0.0;
  if (!leaf) {
    de_factors(k, 0.0, h_node, &log_d, &e);
    c = e;
  }
  de_factors(k, c, dt, &log_d, &e);
  if (!(dt > 0.0)) log_d = -INFINITY;
  return (float)(log_d + (leaf ? 0.0 : k.log_la()));
}

__device__ __forceinline__ float bd_term_local(double h_node, double h_parent, bool leaf,
                                               double la, double mu) {
  return bd_term_local(h_node, h_parent, leaf, BdRates{la, mu});
}

// The truncated normal of the node slides and subtree scales (ops/dists.py)
// and the soft-calibration term (ops/local_terms.py).

__device__ inline float ndtr(float x) {
  const float t = x * kSqrt1_2;
  const float z = fabsf(t);
  if (z < kSqrt1_2) return 0.5f + 0.5f * erff(t);
  const float y = 0.5f * erfcf(z);
  return t > 0.f ? 1.0f - y : y;
}

__device__ inline float log_ndtr(float x) {
  const float t = x * kSqrt1_2;
  if (x < -1.0f) return logf(erfcxf(-t) / 2.0f) - t * t;
  return log1pf(-erfcf(t) / 2.0f);
}

// torch.clamp / torch.maximum semantics: NaN propagates.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  if (isnan(x)) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}

// log(Phi(beta) - Phi(alpha)), stably in the tails (_truncnorm_log_z).
__device__ inline float truncnorm_log_z(float mean, float sd, float a, float b) {
  const float alpha = (a - mean) / sd;
  const float beta = (b - mean) / sd;
  const bool flip = alpha + beta > 0.f;
  const float lo = flip ? -beta : alpha;
  const float hi = flip ? -alpha : beta;
  const float llo = log_ndtr(lo);
  const float lhi = log_ndtr(hi);
  float diff = llo - lhi;
  if (!isnan(diff) && diff > 0.f) diff = 0.f;
  return lhi + log1pf(-expf(diff) + FLT_MIN);
}

__device__ inline float truncnorm_logpdf(float mean, float sd, float a, float b, float x) {
  if (!(x >= a && x <= b)) return -INFINITY;
  const float z = (x - mean) / sd;
  return -kLnSqrt2Pi - logf(sd) - 0.5f * z * z - truncnorm_log_z(mean, sd, a, b);
}

// truncated_normal_sample (ops/dists.py) at the uniform u.
__device__ inline void truncnorm_sample(float u, float mean, float sd, float tune, float a,
                                        float b, float* x_out, float* lq_out) {
  const float s = tune * sd;
  const float alpha = (a - mean) / s;
  const float beta = (b - mean) / s;
  const float pa = ndtr(alpha);
  const float pb = ndtr(beta);
  const float p = pa + u * (pb - pa);
  float x = mean + s * normcdfinvf(clamp_nan(p, FLT_MIN, 1.0f - 10.0f * FLT_EPSILON));
  const float eps = 32.0f * FLT_EPSILON;
  const float width = isfinite(b - a) ? b - a : s;
  const float lo = isfinite(a) ? a + eps * width : -INFINITY;
  const float hi = isfinite(b) ? b - eps * width : INFINITY;
  x = clamp_nan(x, lo, hi);
  *x_out = x;
  *lq_out = truncnorm_logpdf(x, s, a, b, mean) - truncnorm_logpdf(mean, s, a, b, x);
}

// One calibration term of a node at relative height h (_cal_terms_local).
__device__ inline float cal_term_local(float h, float height, float lo, float lo_s, float hi,
                                       float hi_s) {
  const float lo_rel = lo / height;
  const float hi_rel = hi / height;
  const float below = clamp_nan(lo_rel - h, 0.f, INFINITY);
  const float above = clamp_nan(h - hi_rel, 0.f, INFINITY);
  const float b = below / (lo_s > 0.f ? lo_s : 1.0f);
  const float u = above / (hi_s > 0.f ? hi_s : 1.0f);
  return -0.5f * (b * b) - 0.5f * (isfinite(hi_rel) ? u * u : 0.0f);
}

}  // namespace mcmcdate
