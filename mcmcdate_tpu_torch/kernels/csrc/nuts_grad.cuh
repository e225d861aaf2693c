// The NUTS kernels' prior gradients (csrc/nuts_step.cu): forward-mode dual
// numbers over the local density terms of DatingModel's flat term vector.
//
// A Dual<T, K> carries a value and its K partial derivatives.  The term
// functions below repeat the plain versions' operations (ops/birth_death.py,
// ops/clocks.py, ops/dists.py and K1's device_math.cuh) on duals, so each
// term's value is K1's (to its last bit where K1 evaluates it in float) and
// its partials are those of the same expression:
//   * the birth-death term of a node in double, in its own height, its
//     parent's, la and mu (K = 4), rounded to float once;
//   * the clock term of a branch, in its rate, its time length and the rate
//     variance (K = 3), for the five clock models, in double;
//   * the rate variance's gamma prior (K = 1), in double.
// lgamma's derivative is a digamma of our own (recurrence to x >= 10, then
// the asymptotic series, in double).
//
// The functions are __host__ __device__ so that a host compiler can check
// them against autograd; nothing here touches CUDA's runtime.

#pragma once

#include <math.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define NUTS_HD __host__ __device__ __forceinline__

namespace mcmcdate {
namespace nuts {

NUTS_HD float m_log(float x) { return logf(x); }
NUTS_HD double m_log(double x) { return log(x); }
NUTS_HD float m_exp(float x) { return expf(x); }
NUTS_HD double m_exp(double x) { return exp(x); }
NUTS_HD float m_log1p(float x) { return log1pf(x); }
NUTS_HD double m_log1p(double x) { return log1p(x); }
NUTS_HD float m_sqrt(float x) { return sqrtf(x); }
NUTS_HD double m_sqrt(double x) { return sqrt(x); }
NUTS_HD float m_fabs(float x) { return fabsf(x); }
NUTS_HD double m_fabs(double x) { return fabs(x); }
NUTS_HD float m_lgamma(float x) { return lgammaf(x); }
NUTS_HD double m_lgamma(double x) { return lgamma(x); }

// digamma(x) for x > 0 (NaN otherwise).
NUTS_HD double digamma(double x) {
  if (!(x > 0.0) || isinf(x)) return x == INFINITY ? INFINITY : NAN;
  double r = 0.0;
  while (x < 10.0) {
    r -= 1.0 / x;
    x += 1.0;
  }
  const double f = 1.0 / (x * x);
  return r + log(x) - 0.5 / x -
         f * (1.0 / 12.0 - f * (1.0 / 120.0 - f * (1.0 / 252.0 - f * (1.0 / 240.0 - f / 132.0))));
}

template <class T, int K>
struct Dual {
  T v;
  T d[K];
};

template <class T, int K>
NUTS_HD Dual<T, K> cst(T v) {
  Dual<T, K> a;
  a.v = v;
#pragma unroll
  for (int i = 0; i < K; ++i) a.d[i] = T(0);
  return a;
}

template <class T, int K>
NUTS_HD Dual<T, K> var(T v, int i) {
  Dual<T, K> a = cst<T, K>(v);
  a.d[i] = T(1);
  return a;
}

// a.v = f, a.d = f' * x.d
template <class T, int K>
NUTS_HD Dual<T, K> chain(const Dual<T, K>& x, T f, T fp) {
  Dual<T, K> a;
  a.v = f;
#pragma unroll
  for (int i = 0; i < K; ++i) a.d[i] = fp * x.d[i];
  return a;
}

template <class T, int K>
NUTS_HD Dual<T, K> operator+(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> c;
  c.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) c.d[i] = a.d[i] + b.d[i];
  return c;
}

template <class T, int K>
NUTS_HD Dual<T, K> operator-(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> c;
  c.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) c.d[i] = a.d[i] - b.d[i];
  return c;
}

template <class T, int K>
NUTS_HD Dual<T, K> operator-(const Dual<T, K>& a) {
  Dual<T, K> c;
  c.v = -a.v;
#pragma unroll
  for (int i = 0; i < K; ++i) c.d[i] = -a.d[i];
  return c;
}

template <class T, int K>
NUTS_HD Dual<T, K> operator*(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> c;
  c.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) c.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return c;
}

template <class T, int K>
NUTS_HD Dual<T, K> operator/(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> c;
  c.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) c.d[i] = (a.d[i] - c.v * b.d[i]) / b.v;
  return c;
}

// Mixed forms with a plain number.
template <class T, int K>
NUTS_HD Dual<T, K> operator+(const Dual<T, K>& a, T b) { return a + cst<T, K>(b); }
template <class T, int K>
NUTS_HD Dual<T, K> operator+(T a, const Dual<T, K>& b) { return cst<T, K>(a) + b; }
template <class T, int K>
NUTS_HD Dual<T, K> operator-(const Dual<T, K>& a, T b) { return a - cst<T, K>(b); }
template <class T, int K>
NUTS_HD Dual<T, K> operator-(T a, const Dual<T, K>& b) { return cst<T, K>(a) - b; }
template <class T, int K>
NUTS_HD Dual<T, K> operator*(const Dual<T, K>& a, T b) { return chain(a, a.v * b, b); }
template <class T, int K>
NUTS_HD Dual<T, K> operator*(T a, const Dual<T, K>& b) { return chain(b, a * b.v, a); }
template <class T, int K>
NUTS_HD Dual<T, K> operator/(const Dual<T, K>& a, T b) { return a / cst<T, K>(b); }
template <class T, int K>
NUTS_HD Dual<T, K> operator/(T a, const Dual<T, K>& b) { return cst<T, K>(a) / b; }

template <class T, int K>
NUTS_HD Dual<T, K> d_log(const Dual<T, K>& x) { return chain(x, m_log(x.v), T(1) / x.v); }
template <class T, int K>
NUTS_HD Dual<T, K> d_exp(const Dual<T, K>& x) {
  const T e = m_exp(x.v);
  return chain(x, e, e);
}
template <class T, int K>
NUTS_HD Dual<T, K> d_log1p(const Dual<T, K>& x) {
  return chain(x, m_log1p(x.v), T(1) / (T(1) + x.v));
}
template <class T, int K>
NUTS_HD Dual<T, K> d_sqrt(const Dual<T, K>& x) {
  const T s = m_sqrt(x.v);
  return chain(x, s, T(0.5) / s);
}
template <class T, int K>
NUTS_HD Dual<T, K> d_fabs(const Dual<T, K>& x) {
  return chain(x, m_fabs(x.v), x.v < T(0) ? T(-1) : T(1));
}
template <class T, int K>
NUTS_HD Dual<T, K> d_lgamma(const Dual<T, K>& x) {
  return chain(x, m_lgamma(x.v), (T)digamma((double)x.v));
}

// -- birth-death (double) ------------------------------------------------

constexpr double kEpsNearCriticalD = 1e-6;

// de_factors (device_math.cuh, ops/birth_death.py:_de_factors) on duals.
template <int K>
NUTS_HD void de_dual(const Dual<double, K>& la, const Dual<double, K>& mu,
                     const Dual<double, K>& c, const Dual<double, K>& dt, Dual<double, K>* log_d,
                     Dual<double, K>* e) {
  using D = Dual<double, K>;
  const D d = la - mu;
  if (fabs(d.v) < kEpsNearCriticalD) {
    const D y_nc = (mu - c * la) * dt;
    const D nom = 1.0 - d * dt;
    const D den = 1.0 + y_nc;
    const D den_safe = den.v == 0.0 ? cst<double, K>(1.0) : den;
    *log_d = (nom.v > 0.0 && den.v != 0.0) ? d_log(nom) - 2.0 * d_log(d_fabs(den_safe))
                                           : cst<double, K>(-INFINITY);
    *e = (c + y_nc) / den_safe;
    return;
  }
  const D c1 = c - 1.0;
  const D t_pos = d_fabs(d) * dt;
  const D z = d_exp(-t_pos);
  const bool pos = d.v > 0.0;
  const D la_c1 = la * c1;
  const D mu_cla = mu - c * la;
  const D mu_c1 = mu * c1;
  const D p = pos ? la_c1 : la_c1 * z;
  const D q = pos ? mu_cla * z : mu_cla;
  const D r = pos ? mu_c1 : mu_c1 * z;
  const D denom = p + q;
  const D denom_safe = denom.v == 0.0 ? cst<double, K>(1.0) : denom;
  const D d_safe = d.v == 0.0 ? cst<double, K>(1.0) : d;
  *log_d = denom.v != 0.0
               ? 2.0 * d_log(d_fabs(d_safe)) - t_pos - 2.0 * d_log(d_fabs(denom_safe))
               : cst<double, K>(-INFINITY);
  *e = (r + q) / denom_safe;
}

// A non-root node's birth-death term (K1's bd_term_k) and its partials in
// (its height, its parent's height, la, mu).
struct BdGrad {
  float v, dh, dhp, dla, dmu;
};

NUTS_HD BdGrad bd_grad(double h, double hp, bool leaf, double la, double mu, double rho) {
  using D = Dual<double, 4>;
  const D H = var<double, 4>(h, 0), HP = var<double, 4>(hp, 1);
  const D LA = var<double, 4>(la, 2), MU = var<double, 4>(mu, 3);
  D c = cst<double, 4>(1.0 - rho), log_d, e;
  if (!leaf) {
    de_dual(LA, MU, c, H, &log_d, &e);
    c = e;
  }
  const D dt = HP - H;
  de_dual(LA, MU, c, dt, &log_d, &e);
  BdGrad g;
  if (!(dt.v > 0.0)) {
    g.v = -INFINITY;
    g.dh = g.dhp = g.dla = g.dmu = 0.f;
    return g;
  }
  const D val = leaf ? log_d + log(rho) : log_d + d_log(LA);
  const float v = (float)val.v;
  g.v = v == INFINITY ? -INFINITY : v;
  g.dh = (float)val.d[0];
  g.dhp = (float)val.d[1];
  g.dla = (float)val.d[2];
  g.dmu = (float)val.d[3];
  return g;
}

// -- clock and scalar densities (double) -----------------------------------
//
// In double although K1's clock terms are float: a clock term's partial in
// the rate variance cancels terms some 1e4 times larger (shape 1/var, its
// lgamma and logs), which float would leave with about 1e-3 of error.  The
// value is rounded to float once.

constexpr double kLnSqrt2PiD = 0.9189385332046727;

template <int K>
NUTS_HD Dual<double, K> log1pmx_dual(const Dual<double, K>& u) {
  if (fabs(u.v) < 0.35) {
    const Dual<double, K> us = u;
    return -(us * us) *
           (0.5 - us * (1.0 / 3.0 -
                        us * (0.25 - us * (0.2 - us * (1.0 / 6.0 - us * (1.0 / 7.0 - us / 8.0))))));
  }
  return d_log1p(u) - u;
}

template <int K>
NUTS_HD Dual<double, K> gamma_logpdf_dual(const Dual<double, K>& shape,
                                          const Dual<double, K>& scale, const Dual<double, K>& x) {
  const bool ok = (x.v > 0.0) && isfinite(x.v) && isfinite(shape.v) && (shape.v > 0.0);
  if (!ok) return cst<double, K>(-INFINITY);
  if (shape.v > 1e2) {
    const Dual<double, K> m = shape * scale;
    const Dual<double, K> d = x / m;
    return 0.5 * d_log(shape) - kLnSqrt2PiD - d_log(m) - d_log(d) +
           shape * log1pmx_dual(d - 1.0) - 1.0 / (12.0 * shape);
  }
  return (shape - 1.0) * d_log(x) - x / scale - shape * d_log(scale) - d_lgamma(shape);
}

template <int K>
NUTS_HD Dual<double, K> gamma_mv_dual(const Dual<double, K>& variance, const Dual<double, K>& x) {
  return gamma_logpdf_dual(1.0 / variance, variance, x);
}

template <int K>
NUTS_HD Dual<double, K> log_normal_dual(const Dual<double, K>& variance,
                                        const Dual<double, K>& x) {
  if (!((x.v > 0.0) && isfinite(x.v))) return cst<double, K>(-INFINITY);
  const Dual<double, K> t = -(kLnSqrt2PiD + d_log(x * d_sqrt(variance)));
  const Dual<double, K> b = d_log(x) + 0.5 * variance;
  const Dual<double, K> e = -(b * b) / (2.0 * variance);
  return t + e;
}

// A non-root branch's clock term (clock_term_local) and its partials in
// (the rate, the branch's time length, the rate variance).
struct ClockGrad {
  float v, dr, dtl, dvar;
};

NUTS_HD ClockGrad clock_grad(int model, double r, double tl, double var_) {
  using D = Dual<double, 3>;
  const D R = var<double, 3>(r, 0), TL = var<double, 3>(tl, 1), V = var<double, 3>(var_, 2);
  const D t = tl > 0.0 ? TL : cst<double, 3>(1.0);
  D lp;
  switch (model) {
    case 0:
      lp = gamma_mv_dual(V, R);
      break;
    case 1:
      lp = log_normal_dual(V, R);
      break;
    case 2:
      lp = tl > 0.0 ? gamma_mv_dual(V / t, R) : cst<double, 3>(-INFINITY);
      break;
    case 3:
      lp = tl > 0.0 ? gamma_mv_dual(V * t, R) : cst<double, 3>(-INFINITY);
      break;
    default:
      lp = tl > 0.0 ? log_normal_dual(V * t, R) : cst<double, 3>(-INFINITY);
      break;
  }
  ClockGrad g;
  g.v = (float)lp.v;
  const bool fin = isfinite(lp.v);
  g.dr = fin ? (float)lp.d[0] : 0.f;
  g.dtl = fin ? (float)lp.d[1] : 0.f;
  g.dvar = fin ? (float)lp.d[2] : 0.f;
  return g;
}

// The rate variance's prior, Gamma(1.5, scale 1/6): its value and
// derivative.
NUTS_HD Dual<double, 1> rate_var_prior(double rv) {
  return gamma_logpdf_dual(cst<double, 1>(1.5), cst<double, 1>(1.0 / 6.0), var<double, 1>(rv, 0));
}

}  // namespace nuts
}  // namespace mcmcdate
