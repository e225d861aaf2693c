// H1 nuts_leapfrog_prologue, H2 nuts_leapfrog_epilogue and H3 nuts_merge:
// the device work of a batched NUTS trajectory (kernels/nuts_step.py).
//
// They replace the XLA-compiled body of the JAX package's nuts_kernel
// (mcmcdate_tpu/engine/hmc.py:126) vmapped over the chains: _leapfrog (118)
// with jax.grad of make_log_density's target (100), the subtree loop's
// sub_body and the merge after each doubling.  A leapfrog step is H1, the
// product z = r P (a library GEMM, B1 under the banded kind, elementwise
// in H2 under the univariate kind) and H2; H3 ends each doubling.
//
// Layout: a CTA of kThreads threads per chain, chains that have stopped (or
// whose subtree has turned or diverged) return at once.  Entry i of a
// chain's [dim] rows, node j of its [N] rows and distance k of its [D] rows
// belong to thread (i, j, k) mod kThreads.  Every sum over a chain is a
// tree reduction in shared memory in a fixed order, and every gradient
// entry gathers its partials in a fixed order (its own terms, its
// children's, its node terms), so a trajectory is the same bits from run
// to run (no atomics).
//
// H1: the drift from the moving end (ends[dir]), the chain's heights and
// rates in its scratch rows, then per node the birth-death and clock terms
// with their partials in double (csrc/nuts_grad.cuh's dual numbers; the
// values round to K1's terms), the node terms' partials into their slots,
// the root-branch Jacobian, a reduction of the log prior and the
// scalars' partials, the gather of g_part = beta_prior grad log prior +
// grad log Jacobian, and r = d - mu in the internal layout.
// H2: log L = const - r.z / 2, the likelihood's gradient through d (H1's
// scratch rows still hold the state), the kick, the end, the checkpoint
// store of an even leaf and every U-turn sum of an odd one in one pass,
// one reduction, then thread 0's decisions (divergence, the multinomial
// take, the weights) and, on a take, the subtree candidate.  Its init mode
// forms h0 and resets the trajectory.
// H3: the biased progressive replace of the proposal, the weights and the
// full-span U-turn check (two dot products).
//
// What bounds them on the H100: bytes, a few [dim] and [D] rows a chain a
// kernel (about 86 and 119 MB at 1000 taxa x 1024 chains for H1 and H2;
// H1's double-precision birth-death terms and their gradient need about a
// fifth of its byte time).  Built with
// -fmad=false, as the plain versions' products round one by one.

#include <cuda_runtime.h>
#include <math.h>

#include "nuts_grad.cuh"

namespace {

using namespace mcmcdate::nuts;

constexpr int kThreads = 256;
constexpr int kMaxDepth = 8;                // the U-turn sums of one leaf: 1 + 2 (kMaxDepth - 1)
constexpr int kRed = 2 * kMaxDepth;
constexpr float kSqrt2OverPiF = 0.7978845608028654f;

struct NutsArgs {
  const int* parent;
  const unsigned char* is_leaf;
  const int* cal_node;
  const float* cal_lower;
  const float* cal_lower_pm;
  const float* cal_upper;
  const float* cal_upper_pm;
  const int* con_young;
  const int* con_old;
  const float* con_pm;
  const int* br_node;  // [n_br, br_width], -1 padding
  const float* br_sd;
  const int* hnode;     // [n_h] node of height coordinate off_h + i
  const int* hcoord;    // [N] coordinate of a node's height, -1 fixed
  const int* rcoord;    // [N] coordinate of a node's rate, -1 root
  const int* ch_ptr;    // [N + 1]
  const int* ch_idx;
  const int* dpos;      // [N] distance entry of a node's branch, root -1
  const int* didx;      // [D] node of distance entry k
  const int* slot_ptr;  // [N + 1] node-term partial slots of a node
  const int* slot_idx;
  const float* mu;       // [D]
  const float* inv_var;  // [D] univariate kind, else null
  const float* heights;  // [C, N] fixed coordinates
  const float* rates;    // [C, N]
  const float* height;   // [C]
  const float* inv_mass;    // [dim]
  const float* beta_lik;    // [C]
  const float* beta_prior;  // [C]
  const float* normals;     // [C, dim] init
  const unsigned char* dirs;  // [C] the doubling's directions (1: forward)
  const float* u;             // [C] (stride u_stride) the leaf's or merge's uniforms
  float* ends_q;  // [2, C, dim]
  float* ends_p;
  float* ends_g;
  float* q_new;   // [C, dim]
  float* p_half;
  float* g_part;
  float* r;  // [C, D]
  float* z;
  float* q_sub;  // [C, dim]
  float* q_prop;
  float* q_ck;  // [max_depth, C, dim]
  float* p_ck;
  float* lp;  // [C]
  float* jac;
  float* logp;
  float* dh;
  float* h0;
  float* log_w;
  float* lw_sub;
  float* sum_acc;
  int* n_steps;
  int* depth;
  unsigned char* stop;
  unsigned char* trn;
  unsigned char* div;
  float* scratch;  // [C, 5, N]
  float* slots;    // [C, n_slots]
  int C, N, D, dim, calibrated, clock_model, n_cal, n_con, n_br, br_width, n_slots, root_left,
      root_right, use_lik, u_stride, leaf, init, max_depth;
  float eps, mean_root_height, rho, lik_const;
};

__device__ __forceinline__ float clip0f(float x) { return x < 0.f ? 0.f : x; }

// torch.logaddexp.
__device__ __forceinline__ float logaddexp_f(float a, float b) {
  if (a == -INFINITY) return b;
  if (b == -INFINITY) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Sum v[0 .. K) over the CTA, in the same tree every time; every thread
// gets the sums.  red holds K * kThreads floats.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) red[k * kThreads + t] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[k * kThreads + t] += red[k * kThreads + t + s];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = red[k * kThreads];
  __syncthreads();
}

__device__ __forceinline__ bool chain_done(const NutsArgs& a, int c) {
  return !a.init && (a.stop[c] | a.trn[c] | a.div[c]) != 0;
}

// ---------------------------------------------------------------------------
// H1
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) nuts_prologue_kernel(const NutsArgs a) {
  __shared__ float red[5 * kThreads];
  __shared__ float jc[7];  // the Jacobian's value and partials
  const int c = blockIdx.x, t = threadIdx.x;
  if (chain_done(a, c)) return;
  const int dim = a.dim, N = a.N;
  const size_t cd = (size_t)c * dim;
  float* qn = a.q_new + cd;
  float* ph = a.p_half + cd;
  if (a.init) {
    for (int i = t; i < dim; i += kThreads) ph[i] = a.normals[cd + i] / sqrtf(a.inv_mass[i]);
  } else {
    const bool fwd = a.dirs[c] != 0;
    const float e = fwd ? a.eps : -a.eps;
    const float he = 0.5f * e;
    const size_t base = (fwd ? (size_t)a.C * dim : 0) + cd;
    for (int i = t; i < dim; i += kThreads) {
      const float p = a.ends_p[base + i] + he * a.ends_g[base + i];
      ph[i] = p;
      qn[i] = a.ends_q[base + i] + (e * a.inv_mass[i]) * p;
    }
  }
  __syncthreads();

  float* hs = a.scratch + (size_t)c * 5 * N;
  float* rs = hs + N;
  float* own = rs + N;  // d/d(own height) of a node's terms
  float* par = own + N;  // d/d(parent's height) of a node's terms
  float* gr = par + N;   // d/d(rate) of a node's clock term
  const float la = qn[0], mu = qn[1], rm = qn[2], rv = qn[3];
  const float H = a.calibrated ? qn[4] : a.height[c];
  for (int j = t; j < N; j += kThreads) {
    const int hc = a.hcoord[j], rc = a.rcoord[j];
    hs[j] = hc >= 0 ? qn[hc] : a.heights[(size_t)c * N + j];
    rs[j] = rc >= 0 ? qn[rc] : a.rates[(size_t)c * N + j];
  }
  __syncthreads();

  const float bp = a.beta_prior[c];
  // acc: the log prior, its partials in la, mu, rv and H.
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = t + 1; j < N; j += kThreads) {
    const int p = a.parent[j];
    const BdGrad b = bd_grad((double)hs[j], (double)hs[p], a.is_leaf[j] != 0, (double)la,
                             (double)mu, (double)a.rho);
    const ClockGrad k = clock_grad(a.clock_model, (double)rs[j], (double)(hs[p] - hs[j]),
                                   (double)rv);
    own[j] = bp * (b.dh - k.dtl);
    par[j] = bp * (b.dhp + k.dtl);
    gr[j] = bp * k.dr;
    acc[0] += b.v + k.v;
    acc[1] += b.dla;
    acc[2] += b.dmu;
    acc[3] += k.dvar;
  }
  float* sl = a.slots + (size_t)c * a.n_slots;
  const int n_nd = a.n_cal + a.n_con + a.n_br;
  for (int k = t; k < n_nd; k += kThreads) {
    if (k < a.n_cal) {
      const float hk = hs[a.cal_node[k]];
      const float lo = a.cal_lower[k] / H, hi = a.cal_upper[k] / H;
      const float s_lo = kSqrt2OverPiF * a.cal_lower_pm[k];
      const float s_hi = kSqrt2OverPiF * a.cal_upper_pm[k];
      const float sl_ = s_lo > 0.f ? s_lo : 1.0f, sh_ = s_hi > 0.f ? s_hi : 1.0f;
      const float b = clip0f(lo - hk) / sl_, u = clip0f(hk - hi) / sh_;
      const bool fin = isfinite(hi);
      const float lp = -0.5f * (b * b) - 0.5f * (fin ? u * u : 0.0f);
      acc[0] += (H > 0.f && hk >= 0.f) ? lp : -INFINITY;
      float dhk = 0.f, dH = 0.f;
      if (lo - hk > 0.f) {
        dhk += b / sl_;
        dH += b * (a.cal_lower[k] / (H * H)) / sl_;
      }
      if (fin && hk - hi > 0.f) {
        dhk -= u / sh_;
        dH -= u * (a.cal_upper[k] / (H * H)) / sh_;
      }
      sl[k] = bp * dhk;
      acc[4] += bp * dH;
    } else if (k < a.n_cal + a.n_con) {
      const int q = k - a.n_cal;
      const float d = hs[a.con_young[q]] - hs[a.con_old[q]];
      const float s = kSqrt2OverPiF * a.con_pm[q];
      const float v = clip0f(d) / s;
      acc[0] += -0.5f * (v * v);
      const float dv = d > 0.f ? v / s : 0.f;
      sl[a.n_cal + 2 * q] = bp * -dv;
      sl[a.n_cal + 2 * q + 1] = bp * dv;
    } else {
      const int q = k - a.n_cal - a.n_con;
      const int W = a.br_width;
      const int* nodes = a.br_node + (size_t)q * W;
      float sum = 0.f;
      int count = 0;
      for (int w = 0; w < W; ++w) {
        if (nodes[w] >= 0) {
          sum += hs[nodes[w]];
          ++count;
        }
      }
      const float hmean = sum / (float)count;
      const float s = a.br_sd[q];
      float lp = 0.f, zsum = 0.f;
      for (int w = 0; w < W; ++w) {
        if (nodes[w] >= 0) {
          const float zz = (hs[nodes[w]] - hmean) / s;
          lp += -0.5f * (zz * zz);
          zsum += zz;
        }
      }
      acc[0] += lp;
      const int base = a.n_cal + 2 * a.n_con + q * W;
      for (int w = 0; w < W; ++w) {
        if (nodes[w] >= 0) {
          const float zz = (hs[nodes[w]] - hmean) / s;
          sl[base + w] = bp * (-zz / s + zsum / ((float)count * s));
        }
      }
    }
  }
  if (t == 0) {
    // The scalar terms and the two validity entries (K1's fixed items).
    const Dual<double, 1> rvp = rate_var_prior((double)rv);
    const float mrh = a.mean_root_height;
    acc[0] += (la >= 0.f ? logf(1.0f) - 1.0f * la : -INFINITY) +
              (mu >= 0.f ? logf(1.0f) - 1.0f * mu : -INFINITY) +
              (rm >= 0.f ? logf(mrh) - mrh * rm : -INFINITY) + (float)rvp.v;
    const bool bd_ok = la >= 0.f && mu >= 0.f && a.rho > 0.f && a.rho <= 1.0f;
    acc[0] += (bd_ok ? 0.0f : -INFINITY) + (rv > 0.f ? 0.0f : -INFINITY);
    // The root-branch Jacobian -log(H rm (t1 r_l + t2 r_r)).
    const int l = a.root_left, rr = a.root_right;
    const float t1 = hs[0] - hs[l], t2 = hs[0] - hs[rr];
    const float S = t1 * rs[l] + t2 * rs[rr];
    const float A = H * rm;
    const float RB = A * S;
    jc[0] = -logf(RB);
    jc[1] = A * rs[l] / RB;   // d/dh_l
    jc[2] = A * rs[rr] / RB;  // d/dh_r
    jc[3] = -(A * t1) / RB;   // d/dr_l
    jc[4] = -(A * t2) / RB;   // d/dr_r
    jc[5] = -(rm * S) / RB;   // d/dH
    jc[6] = -(H * S) / RB;    // d/drm
    acc[1] += la >= 0.f ? -1.0f : 0.f;
    acc[2] += mu >= 0.f ? -1.0f : 0.f;
    acc[3] += (float)rvp.d[0];
  }
  block_sum(acc, red);

  const int off_h = 4 + a.calibrated, off_r = dim - (N - 1);
  float* g = a.g_part + cd;
  for (int i = t; i < dim; i += kThreads) {
    float v;
    if (i < off_h) {
      if (i == 0) v = bp * acc[1];
      else if (i == 1) v = bp * acc[2];
      else if (i == 2) v = bp * (rm >= 0.f ? -a.mean_root_height : 0.f) + jc[6];
      else if (i == 3) v = bp * acc[3];
      else v = acc[4] + jc[5];
    } else if (i < off_r) {
      const int n = a.hnode[i - off_h];
      v = own[n];
      for (int q = a.ch_ptr[n]; q < a.ch_ptr[n + 1]; ++q) v += par[a.ch_idx[q]];
      for (int q = a.slot_ptr[n]; q < a.slot_ptr[n + 1]; ++q) v += sl[a.slot_idx[q]];
      if (n == a.root_left) v += jc[1];
      if (n == a.root_right) v += jc[2];
    } else {
      const int n = i - off_r + 1;
      v = gr[n];
      if (n == a.root_left) v += jc[3];
      if (n == a.root_right) v += jc[4];
    }
    g[i] = v;
  }
  if (a.use_lik) {
    const float Hrm = H * rm;
    const int rr = a.root_right, prr = a.parent[rr];
    const float lens_rr = (hs[prr] - hs[rr]) * rs[rr];
    float* rk = a.r + (size_t)c * a.D;
    for (int k = t; k < a.D; k += kThreads) {
      const int n = a.didx[k];
      float lens = (hs[a.parent[n]] - hs[n]) * rs[n];
      if (k == 0) lens += lens_rr;
      rk[k] = lens * Hrm - a.mu[k];
    }
  }
  if (t == 0) {
    a.lp[c] = acc[0];
    a.jac[c] = jc[0];
  }
}

// ---------------------------------------------------------------------------
// H2
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) nuts_epilogue_kernel(const NutsArgs a) {
  __shared__ float red[kRed * kThreads];
  __shared__ int s_take;
  const int c = blockIdx.x, t = threadIdx.x;
  if (chain_done(a, c)) return;
  const int dim = a.dim, N = a.N, C = a.C;
  const size_t cd = (size_t)c * dim;
  const float* qn = a.q_new + cd;
  const float* ph = a.p_half + cd;
  const float* hs = a.scratch + (size_t)c * 5 * N;
  const float* rs = hs + N;
  float* gtl = const_cast<float*>(rs) + N;  // d(beta_lik log L)/d(time length) a node
  float* glr = gtl + N;                      // d(beta_lik log L)/d(rate) a node
  const float rm = qn[2];
  const float H = a.calibrated ? qn[4] : a.height[c];
  const float Hrm = H * rm;
  const float bl = a.beta_lik[c], bp = a.beta_prior[c];
  // lk: r.z and the sum over nodes of d(beta log L)/d d_k times the lens.
  float lk[2] = {0.f, 0.f};
  if (a.use_lik) {
    const float* rk = a.r + (size_t)c * a.D;
    const float* zk = a.z + (size_t)c * a.D;
    for (int k = t; k < a.D; k += kThreads) {
      const float z = a.inv_var ? rk[k] * a.inv_var[k] : zk[k];
      lk[0] += rk[k] * z;
    }
    for (int j = t + 1; j < N; j += kThreads) {
      const int k = a.dpos[j];
      const float z = a.inv_var ? rk[k] * a.inv_var[k] : zk[k];
      const float gd = -bl * z;
      const float tl = hs[a.parent[j]] - hs[j];
      gtl[j] = gd * rs[j] * Hrm;
      glr[j] = gd * tl * Hrm;
      lk[1] += gd * (tl * rs[j]);
    }
  }
  block_sum(lk, red);
  const float log_l = a.use_lik ? a.lik_const - 0.5f * lk[0] : 0.0f;
  float target = bp * a.lp[c] + bl * log_l + a.jac[c];
  if (isnan(target)) target = -INFINITY;

  const int off_h = 4 + a.calibrated, off_r = dim - (N - 1);
  const bool fwd = !a.init && a.dirs[c] != 0;
  const float e = fwd ? a.eps : -a.eps;
  const float he = 0.5f * e, sgn = fwd ? 1.0f : -1.0f;
  const int leaf = a.leaf;
  const int tt = a.init ? 0 : __popc(leaf ^ (leaf + 1)) - 1;  // the leaf's trailing ones
  const bool store = !a.init && (leaf % 2 == 0);
  const size_t plane = (size_t)C * dim;
  const size_t base = (fwd ? plane : 0) + cd;
  const size_t ck_store = (size_t)__popc(leaf) * plane + cd;
  size_t ck_a[kMaxDepth];
#pragma unroll
  for (int j = 1; j < kMaxDepth; ++j)
    ck_a[j] = j <= tt ? (size_t)__popc(leaf + 1 - (1 << j)) * plane + cd : 0;
  // acc: the kinetic sum, then per check j the two U-turn dot products.
  float acc[kRed];
#pragma unroll
  for (int k = 0; k < kRed; ++k) acc[k] = 0.f;
  for (int i = t; i < dim; i += kThreads) {
    float g = a.g_part[cd + i];
    if (a.use_lik) {
      if (i == 2) {
        g += lk[1] * H;
      } else if (i == 4 && a.calibrated) {
        g += lk[1] * rm;
      } else if (i >= off_h && i < off_r) {
        const int n = a.hnode[i - off_h];
        float v = -gtl[n];
        for (int q = a.ch_ptr[n]; q < a.ch_ptr[n + 1]; ++q) v += gtl[a.ch_idx[q]];
        g += v;
      } else if (i >= off_r) {
        g += glr[i - off_r + 1];
      }
    }
    const float im = a.inv_mass[i];
    const float q = qn[i];
    float p;
    if (a.init) {
      p = ph[i];
      a.ends_q[cd + i] = q;
      a.ends_q[plane + cd + i] = q;
      a.ends_p[cd + i] = p;
      a.ends_p[plane + cd + i] = p;
      a.ends_g[cd + i] = g;
      a.ends_g[plane + cd + i] = g;
      a.q_prop[cd + i] = q;
    } else {
      p = ph[i] + he * g;
      if (leaf == 0) a.q_sub[cd + i] = a.ends_q[base + i];
      a.ends_q[base + i] = q;
      a.ends_p[base + i] = p;
      a.ends_g[base + i] = g;
      if (store) {
        a.q_ck[ck_store + i] = q;
        a.p_ck[ck_store + i] = p;
      }
      const float pim = p * im;
#pragma unroll
      for (int j = 1; j < kMaxDepth; ++j) {
        if (j <= tt) {
          const float dq = sgn * (q - a.q_ck[ck_a[j] + i]);
          acc[2 * j - 1] += dq * (a.p_ck[ck_a[j] + i] * im);
          acc[2 * j] += dq * pim;
        }
      }
    }
    acc[0] += (p * p) * im;
  }
  block_sum(acc, red);
  if (t == 0) {
    const float h = target - 0.5f * acc[0];
    a.logp[c] = target;
    if (a.init) {
      a.h0[c] = h;
      a.log_w[c] = 0.f;
      a.lw_sub[c] = -INFINITY;
      a.sum_acc[c] = 0.f;
      a.n_steps[c] = 0;
      a.depth[c] = 0;
      a.stop[c] = a.trn[c] = a.div[c] = 0;
      s_take = 0;
    } else {
      const float dh = h - a.h0[c];
      a.dh[c] = dh;
      const bool div_new = dh < -1000.0f || isnan(dh);
      const float dh_s = isnan(dh) ? -INFINITY : dh;
      const float lw_old = a.lw_sub[c];
      const float lw_new = div_new ? lw_old : logaddexp_f(lw_old, dh_s);
      const bool take = !div_new && logf(a.u[(size_t)c * a.u_stride]) < dh_s - lw_new;
      a.sum_acc[c] += fminf(expf(dh_s), 1.0f);
      a.n_steps[c] += 1;
      a.lw_sub[c] = lw_new;
      bool turn = false;
#pragma unroll
      for (int j = 1; j < kMaxDepth; ++j)
        if (j <= tt) turn = turn || acc[2 * j - 1] < 0.f || acc[2 * j] < 0.f;
      if (turn && !div_new) a.trn[c] = 1;
      if (div_new) a.div[c] = 1;
      s_take = take;
    }
  }
  __syncthreads();
  if (s_take) {
    for (int i = t; i < dim; i += kThreads) a.q_sub[cd + i] = qn[i];
  }
}

// ---------------------------------------------------------------------------
// H3
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) nuts_merge_kernel(const NutsArgs a) {
  __shared__ float red[2 * kThreads];
  const int c = blockIdx.x, t = threadIdx.x;
  if (a.stop[c]) return;
  const int dim = a.dim;
  const size_t cd = (size_t)c * dim, plane = (size_t)a.C * dim;
  const bool bad = (a.trn[c] | a.div[c]) != 0;
  const float lw_sub = a.lw_sub[c], log_w = a.log_w[c];
  const bool replace = !bad && logf(a.u[(size_t)c * a.u_stride]) < lw_sub - log_w;
  float acc[2] = {0.f, 0.f};
  for (int i = t; i < dim; i += kThreads) {
    if (replace) a.q_prop[cd + i] = a.q_sub[cd + i];
    const float im = a.inv_mass[i];
    const float dq = a.ends_q[plane + cd + i] - a.ends_q[cd + i];
    acc[0] += dq * (a.ends_p[cd + i] * im);
    acc[1] += dq * (a.ends_p[plane + cd + i] * im);
  }
  block_sum(acc, red);
  if (t == 0) {
    if (!bad) a.log_w[c] = logaddexp_f(log_w, lw_sub);
    a.stop[c] = bad || acc[0] < 0.f || acc[1] < 0.f;
    a.depth[c] += 1;
    a.lw_sub[c] = -INFINITY;
    a.trn[c] = a.div[c] = 0;
  }
}

}  // namespace

extern "C" int mcmcdate_nuts_args_size() { return (int)sizeof(NutsArgs); }

extern "C" int mcmcdate_nuts_leapfrog_prologue_f32(const void* args, void* stream) {
  const NutsArgs& a = *static_cast<const NutsArgs*>(args);
  if (a.max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  if (a.C > 0) nuts_prologue_kernel<<<a.C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_nuts_leapfrog_epilogue_f32(const void* args, void* stream) {
  const NutsArgs& a = *static_cast<const NutsArgs*>(args);
  if (a.max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  if (a.C > 0) nuts_epilogue_kernel<<<a.C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcmcdate_nuts_merge_f32(const void* args, void* stream) {
  const NutsArgs& a = *static_cast<const NutsArgs*>(args);
  if (a.C > 0) nuts_merge_kernel<<<a.C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
