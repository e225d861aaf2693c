// Device versions of the port's plain-torch densities, shared by the
// kernels that evaluate prior terms (K1 prior_terms, K6 contra_step).
// Each mirrors its plain version operation by operation (ops/dists.py,
// ops/birth_death.py); build without fast math so isnan/isinf/-inf are
// exact.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mcmcdate {

constexpr float kLnSqrt2Pi = 0.9189385332046727f;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr double kEpsNearCritical = 1e-6;

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

// log D and E at the top of a branch of length dt (ops/birth_death.py:19),
// in double.
__device__ __forceinline__ void de_factors(double la, double mu, double c, double dt,
                                           double* log_d, double* e) {
  const double d = la - mu;
  if (fabs(d) < kEpsNearCritical) {
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
  const double d_safe = d == 0.0 ? 1.0 : d;
  *log_d = denom != 0.0 ? 2.0 * log(fabs(d_safe)) - t_pos - 2.0 * log(fabs(denom_safe))
                        : -INFINITY;
  *e = (r + q) / denom_safe;
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

// Birth-death term of a non-root node with rho = 1 (bd_term_local,
// ops/local_terms.py), in double and rounded once.
__device__ __forceinline__ float bd_term_local(double h_node, double h_parent, bool leaf,
                                               double la, double mu) {
  double log_d, e;
  const double dt = h_parent - h_node;
  double c = 0.0;
  if (!leaf) {
    de_factors(la, mu, 0.0, h_node, &log_d, &e);
    c = e;
  }
  de_factors(la, mu, c, dt, &log_d, &e);
  if (!(dt > 0.0)) log_d = -INFINITY;
  return (float)(log_d + (leaf ? 0.0 : log(la)));
}

}  // namespace mcmcdate
