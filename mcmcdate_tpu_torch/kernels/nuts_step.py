"""H1 ``nuts_leapfrog_prologue``, H2 ``nuts_leapfrog_epilogue`` and H3
``nuts_merge``: the device work of a NUTS trajectory, every chain at once.

Replaces the XLA-compiled body of the JAX package's ``nuts_kernel``
(``mcmcdate_tpu/engine/hmc.py:126``), vmapped over the chains by
``make_in_cycle_move`` (291): each ``_leapfrog`` step (118) with its
``jax.grad`` of the target of ``make_log_density`` (100), the body of the
subtree loop (``sub_body``) and the merge after each doubling.  A leapfrog
step is H1, the product ``z = r P`` and H2; a doubling of ``2^k`` steps
ends with H3.  ``engine/hmc.py`` runs the host loop over the doublings.

* H1 (a CTA per chain): the drift ``p_half = p + eps/2 g``, ``q' = q + eps
  M^-1 p_half`` from the trajectory's moving end, the state of ``q'``, its
  internal-layout distances ``d`` and ``r = d - mu``, the log prior (K1's
  terms, ``csrc/prior_terms.cuh``) and the root-branch Jacobian with their
  gradient: the birth-death and clock terms by forward-mode dual numbers
  in double, the node terms by hand
  (``csrc/nuts_grad.cuh``); each coordinate gathers its partials from its
  own terms and its children's in a fixed order (no atomics), so a
  trajectory is reproducible.
* The product: ``z = r P`` (``torch.mm`` under the full kind, B1
  ``band_matmul`` under the banded one; elementwise in H2 under the
  univariate kind; none without a likelihood).  ``grad_d log L = -z``.
* H2 (a CTA per chain): ``log L = const - r.z/2``, the gradient ``g =
  beta_prior g_prior + g_jac + beta_lik (dd/dq)' (-z)``, the kick, the
  energy error, the divergence test, the progressive multinomial take, the
  checkpoint store at slot ``popcount(i)`` and every sub-subtree U-turn
  check of leaf ``i``.  Its init mode forms ``h0`` and resets the
  trajectory.
* H3 (a CTA per chain): the biased progressive replace, the weights, the
  full-span U-turn check, ``stop`` and ``depth``.

The trajectory's moving end is kept in place (``ends_q[dir]``): a subtree
that turns or diverges stops the trajectory, and nothing reads an end
after that, so the JAX package's copies of the ends are not needed.

On the H100 all three are bound by their bytes: H1 and H2 by a chain's
``[dim]`` and ``[D]`` rows, a few of each (H1's float64 birth-death terms
and their gradient need about a fifth of its byte time), H3 by its two
dot products'.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.state import FIELDS, State
from ..ops import clocks, mvn
from ..ops.heights import distances_internal, log_jacobian_root_branch
from . import build


MAX_DEPTH = 8  # the kernels' bound on a trajectory's doublings (csrc/nuts_step.cu)


def _popcount(i: int) -> int:
    return bin(i).count("1")


@dataclass
class NutsConsts:
    """A model's static arrays as H1 and H2 read them (int32 and float32
    tensors on the model's device) and the host values of the plain
    versions."""

    model: object
    coords: object
    hnode: torch.Tensor  # [n_h] node of height coordinate off_h + i
    hcoord: torch.Tensor  # [N] coordinate of a node's height (-1: fixed)
    rcoord: torch.Tensor  # [N] coordinate of a node's rate (-1: root)
    ch_ptr: torch.Tensor  # [N+1] children of node i: ch_idx[ch_ptr[i]:ch_ptr[i+1]]
    ch_idx: torch.Tensor
    dpos: torch.Tensor  # [N] internal distance entry of node i's branch (root -1)
    didx: torch.Tensor  # [D] node of distance entry k
    slot_ptr: torch.Tensor  # [N+1] node-term partial slots of node i
    slot_idx: torch.Tensor
    n_slots: int
    mu: torch.Tensor  # [D] (None without a likelihood)
    inv_var: torch.Tensor  # [D] univariate kind: 1 / variance (else None)
    lik_const: float
    use_lik: bool


def nuts_consts(model, coords) -> NutsConsts:
    """The static arrays of ``model`` for ``coords`` (:class:`FlatCoords`)."""
    topo = model.topo
    N = topo.n
    dev = model.device
    parent = np.asarray(topo.parent)
    hcoord = np.full(N, -1, np.int32)
    hcoord[coords.height_idx] = coords.off_h + np.arange(len(coords.height_idx))
    rcoord = np.full(N, -1, np.int32)
    rcoord[coords.rate_idx] = coords.off_r + np.arange(len(coords.rate_idx))
    kids = [[] for _ in range(N)]
    for j in range(1, N):
        kids[parent[j]].append(j)
    ch_ptr = np.cumsum([0] + [len(k) for k in kids]).astype(np.int32)
    ch_idx = np.asarray([c for k in kids for c in k] or [0], np.int32)
    # Node-term partial slots: calibration k at slot k, constraint k at
    # n_cal + 2k (young) and + 1 (old), brace k's node w at n_cal + 2 n_con
    # + k W + w.
    cal, con, br = model.calibrations, model.constraints, model.braces
    owners = [[] for _ in range(N)]
    for k in range(cal.n):
        owners[int(np.asarray(cal.node)[k])].append(k)
    for k in range(con.n):
        owners[int(np.asarray(con.young)[k])].append(cal.n + 2 * k)
        owners[int(np.asarray(con.old)[k])].append(cal.n + 2 * k + 1)
    W = int(np.asarray(br.node).shape[1]) if br.n else 0
    for k in range(br.n):
        for w, nd in enumerate(np.asarray(br.node)[k]):
            if nd >= 0:
                owners[int(nd)].append(cal.n + 2 * con.n + k * W + w)
    slot_ptr = np.cumsum([0] + [len(o) for o in owners]).astype(np.int32)
    slot_idx = np.asarray([s for o in owners for s in o] or [0], np.int32)
    kind = model.likelihood.kind
    use_lik = kind != mvn.NONE

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    inv_var = None
    if kind == mvn.UNIVARIATE:
        s = np.asarray(model.inv_sd_internal, np.float64)
        inv_var = torch.as_tensor(s * s, dtype=model.dtype, device=dev)
    return NutsConsts(
        model=model, coords=coords, hnode=i32(coords.height_idx), hcoord=i32(hcoord),
        rcoord=i32(rcoord), ch_ptr=i32(ch_ptr), ch_idx=i32(ch_idx),
        dpos=i32(topo.internal_pos), didx=i32(topo.internal_dist_index),
        slot_ptr=i32(slot_ptr), slot_idx=i32(slot_idx),
        n_slots=cal.n + 2 * con.n + br.n * W,
        mu=model.mu_internal_t if use_lik else None, inv_var=inv_var,
        lik_const=float(model.log_lik_const), use_lik=use_lik)


class NutsWork:
    """A trajectory's buffers for ``C`` chains: the two ends ``[2, C, dim]``
    (0 the backward end, 1 the forward one), the leapfrog step's outputs,
    the subtree's candidate, the proposal, the checkpoints ``[max_depth, C,
    dim]``, the per-chain scalars and flags, and H1's scratch."""

    def __init__(self, C: int, dim: int, N: int, D: int, n_slots: int, max_depth: int,
                 dtype, device):
        def f(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        def b():
            return torch.zeros(C, dtype=torch.bool, device=device)

        self.C, self.dim, self.max_depth = C, dim, max_depth
        self.ends_q, self.ends_p, self.ends_g = f(2, C, dim), f(2, C, dim), f(2, C, dim)
        self.q_new, self.p_half, self.g_part = f(C, dim), f(C, dim), f(C, dim)
        self.r, self.z = f(C, D), f(C, D)
        self.q_sub, self.q_prop = f(C, dim), f(C, dim)
        self.q_ck, self.p_ck = f(max_depth, C, dim), f(max_depth, C, dim)
        # H1's log prior and Jacobian; H2's target and energy error at the
        # leaf, and h0; the trajectory's weights.
        self.lp, self.jac, self.logp, self.dh, self.h0 = f(C), f(C), f(C), f(C), f(C)
        self.log_w, self.lw_sub, self.sum_acc = f(C), f(C), f(C)
        self.n_steps = torch.zeros(C, dtype=torch.int32, device=device)
        self.depth = torch.zeros(C, dtype=torch.int32, device=device)
        self.stop, self.trn, self.div = b(), b(), b()
        # H1 and H2 only: each chain's state (heights, rates) and per-node
        # partials (own branch, parent side, rate), and node-term slots.
        self.scratch = f(C, 5, N) if device.type == "cuda" else None
        self.slots = f(C, max(n_slots, 1)) if device.type == "cuda" else None
        self.args = None  # the kernels' argument struct of this trajectory


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _end(ends, dirs):
    return torch.where(dirs[:, None], ends[1], ends[0])


def _signed_eps(eps, dirs, like):
    return torch.where(dirs, 1.0, -1.0).to(like.dtype)[:, None] * eps


def nuts_leapfrog_prologue_plain(nc: NutsConsts, w: NutsWork, state, eps: float, inv_mass,
                                 beta_lik, beta_prior, dirs=None, normals=None) -> None:
    """Plain version of :func:`nuts_leapfrog_prologue` (in place on ``w``;
    the gradient by ``torch.autograd``; ``beta_lik`` is H2's)."""
    model, coords = nc.model, nc.coords
    if normals is not None:
        active = torch.ones_like(w.stop)
        q = w.q_new.clone()
        p_half = normals / torch.sqrt(inv_mass)
    else:
        active = ~(w.stop | w.trn | w.div)
        e = _signed_eps(eps, dirs, w.q_new)
        p_half = _end(w.ends_p, dirs) + 0.5 * e * _end(w.ends_g, dirs)
        q = _end(w.ends_q, dirs) + e * inv_mass * p_half
    # The prior's gradient in float64 whatever the state's type (the
    # kernel's partials are double too: see csrc/nuts_grad.cuh).
    f64 = torch.float64
    with torch.enable_grad():
        qv = q.detach().to(f64).requires_grad_(True)
        s = coords.from_vector(State(**{k: getattr(state, k).to(f64) for k in FIELDS}), qv)
        lp = model.log_prior(s)
        jac = log_jacobian_root_branch(s, model.topo)
        obj = beta_prior.to(f64) * lp + jac
        g, = torch.autograd.grad(obj.sum(), qv)
    a = active[:, None]
    dt = w.q_new.dtype
    w.q_new.copy_(torch.where(a, q, w.q_new))
    w.p_half.copy_(torch.where(a, p_half, w.p_half))
    w.g_part.copy_(torch.where(a, g.to(dt), w.g_part))
    w.lp.copy_(torch.where(active, lp.detach().to(dt), w.lp))
    w.jac.copy_(torch.where(active, jac.detach().to(dt), w.jac))
    if nc.use_lik:
        s = coords.from_vector(state, q)
        r = distances_internal(s, model.topo) - nc.mu
        w.r.copy_(torch.where(a, r, w.r))


def _lik_grad(nc: NutsConsts, state, q, cot):
    """``(dd/dq)' cot`` for the internal-layout distances ``d(q)``."""
    with torch.enable_grad():
        qv = q.detach().requires_grad_(True)
        d = distances_internal(nc.coords.from_vector(state, qv), nc.model.topo)
        g, = torch.autograd.grad(d, qv, grad_outputs=cot)
    return g


def _uturn(dq, p_a, p_b, inv_mass):
    return (torch.sum(dq * (p_a * inv_mass), dim=1) < 0) | (
        torch.sum(dq * (p_b * inv_mass), dim=1) < 0)


def nuts_leapfrog_epilogue_plain(nc: NutsConsts, w: NutsWork, state, eps: float, inv_mass,
                                 beta_lik, beta_prior, dirs=None, u_leaf=None,
                                 leaf: int = 0) -> None:
    """Plain version of :func:`nuts_leapfrog_epilogue` (in place on ``w``)."""
    q, p_half = w.q_new, w.p_half
    if nc.use_lik:
        z = w.r * nc.inv_var if nc.inv_var is not None else w.z
        log_l = nc.lik_const - 0.5 * torch.sum(w.r * z, dim=1)
        g = w.g_part + _lik_grad(nc, state, q, -beta_lik[:, None] * z)
    else:
        log_l = torch.zeros_like(w.lp)
        g = w.g_part
    logp = beta_prior * w.lp + beta_lik * log_l + w.jac
    logp = torch.where(torch.isnan(logp), -math.inf, logp)
    if dirs is None:
        w.logp.copy_(logp)
        w.h0.copy_(logp - 0.5 * torch.sum(p_half * p_half * inv_mass, dim=1))
        for ends, x in ((w.ends_q, q), (w.ends_p, p_half), (w.ends_g, g)):
            ends[0].copy_(x)
            ends[1].copy_(x)
        w.q_prop.copy_(q)
        for t in (w.log_w, w.sum_acc, w.n_steps, w.depth):
            t.zero_()
        w.lw_sub.fill_(-math.inf)
        for t in (w.stop, w.trn, w.div):
            t.zero_()
        return
    active = ~(w.stop | w.trn | w.div)
    w.logp.copy_(torch.where(active, logp, w.logp))
    e = _signed_eps(eps, dirs, q)
    p = p_half + 0.5 * e * g
    h = logp - 0.5 * torch.sum(p * p * inv_mass, dim=1)
    dh = h - w.h0
    w.dh.copy_(torch.where(active, dh, w.dh))
    div_new = active & ((dh < -1000.0) | torch.isnan(dh))
    dh_s = torch.where(torch.isnan(dh), -math.inf, dh)
    lw_new = torch.where(~active | div_new, w.lw_sub, torch.logaddexp(w.lw_sub, dh_s))
    take = active & ~div_new & (torch.log(u_leaf) < dh_s - lw_new)
    # Checkpoint store (even leaves) and sub-subtree U-turn checks (leaf i
    # completes the subtrees of size 2^j, j <= t, t its trailing ones).
    if leaf % 2 == 0:
        slot = _popcount(leaf)
        a = active[:, None]
        w.q_ck[slot].copy_(torch.where(a, q, w.q_ck[slot]))
        w.p_ck[slot].copy_(torch.where(a, p, w.p_ck[slot]))
    t = _popcount(leaf ^ (leaf + 1)) - 1
    sgn = torch.where(dirs, 1.0, -1.0).to(q.dtype)[:, None]
    trn_sub = torch.zeros_like(active)
    for j in range(1, t + 1):
        sa = _popcount(leaf + 1 - 2 ** j)
        trn_sub |= _uturn(sgn * (q - w.q_ck[sa]), w.p_ck[sa], p, inv_mass)
    trn_sub &= active & ~div_new
    a = active[:, None]
    q_sub0 = _end(w.ends_q, dirs) if leaf == 0 else w.q_sub
    w.q_sub.copy_(torch.where(a & take[:, None], q, torch.where(a, q_sub0, w.q_sub)))
    w.sum_acc.add_(torch.where(active, torch.clamp(torch.exp(dh_s), max=1.0), 0.0))
    w.n_steps.add_(active.to(w.n_steps.dtype))
    w.lw_sub.copy_(lw_new)
    w.trn |= trn_sub
    w.div |= div_new
    for ends, x in ((w.ends_q, q), (w.ends_p, p), (w.ends_g, g)):
        sel = (a & dirs[:, None], a & ~dirs[:, None])
        ends[1].copy_(torch.where(sel[0], x, ends[1]))
        ends[0].copy_(torch.where(sel[1], x, ends[0]))


def nuts_merge_plain(w: NutsWork, inv_mass, u_merge) -> None:
    """Plain version of :func:`nuts_merge` (in place on ``w``)."""
    active = ~w.stop
    bad = w.trn | w.div
    replace = active & ~bad & (torch.log(u_merge) < w.lw_sub - w.log_w)
    w.q_prop.copy_(torch.where(replace[:, None], w.q_sub, w.q_prop))
    w.log_w.copy_(torch.where(active & ~bad, torch.logaddexp(w.log_w, w.lw_sub), w.log_w))
    turning = _uturn(w.ends_q[1] - w.ends_q[0], w.ends_p[0], w.ends_p[1], inv_mass)
    w.stop |= active & (bad | turning)
    w.depth.add_(active.to(w.depth.dtype))
    w.lw_sub.copy_(torch.where(active, -math.inf, w.lw_sub))
    w.trn &= ~active
    w.div &= ~active


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_PTRS = ("parent", "is_leaf", "cal_node", "cal_lower", "cal_lower_pm", "cal_upper",
         "cal_upper_pm", "con_young", "con_old", "con_pm", "br_node", "br_sd", "hnode",
         "hcoord", "rcoord", "ch_ptr", "ch_idx", "dpos", "didx", "slot_ptr", "slot_idx",
         "mu", "inv_var", "heights", "rates", "height", "inv_mass", "beta_lik", "beta_prior",
         "normals", "dirs", "u", "ends_q", "ends_p", "ends_g", "q_new", "p_half", "g_part",
         "r", "z", "q_sub", "q_prop", "q_ck", "p_ck", "lp", "jac", "logp", "dh", "h0", "log_w",
         "lw_sub", "sum_acc", "n_steps", "depth", "stop", "trn", "div", "scratch", "slots")
_INTS = ("C", "N", "D", "dim", "calibrated", "clock_model", "n_cal", "n_con", "n_br",
         "br_width", "n_slots", "root_left", "root_right", "use_lik", "u_stride", "leaf",
         "init", "max_depth")
_FLOATS = ("eps", "mean_root_height", "rho", "lik_const")


class _NutsArgs(ctypes.Structure):
    """``NutsArgs`` of ``csrc/nuts_step.cu``, field by field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_float) for k in _FLOATS])


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    if build.bind("mcmcdate_nuts_args_size", ())() != ctypes.sizeof(_NutsArgs):
        raise RuntimeError("nuts_step: the kernel's argument layout does not match the wrapper's")


def _bind_args(nc: NutsConsts, w: NutsWork, state, inv_mass, beta_lik, beta_prior):
    """The argument struct of a trajectory (its pointers fixed until the
    next init), after checking the tensors."""
    _check_layout()
    model = nc.model
    C, N = state.heights.shape
    for name, t in (("heights", state.heights), ("rates", state.rates),
                    ("height", state.height), ("inv_mass", inv_mass),
                    ("beta_lik", beta_lik), ("beta_prior", beta_prior)):
        build.require_cuda(t, name, torch.float32)
    if inv_mass.shape != (w.dim,) or beta_lik.shape != (C,) or beta_prior.shape != (C,):
        raise ValueError("nuts_step: inv_mass must be [dim], beta_lik and beta_prior [C]")
    if w.C != C or w.ends_q.dtype != torch.float32:
        raise ValueError("nuts_step: the work buffers must be float32 and hold every chain")
    if w.max_depth > MAX_DEPTH:
        raise ValueError(f"nuts_step: the kernels take a max_depth of at most {MAX_DEPTH}")
    ka = model.prior_kernel_arrays
    cal, con, br = ka["cal"], ka["con"], ka["br"]
    rl, rr = model.topo.root_children
    args = dict(
        parent=ka["parent"], is_leaf=ka["is_leaf"], cal_node=cal[0], cal_lower=cal[1],
        cal_lower_pm=cal[2], cal_upper=cal[3], cal_upper_pm=cal[4], con_young=con[0],
        con_old=con[1], con_pm=con[2], br_node=br[0], br_sd=br[1],
        hnode=nc.hnode, hcoord=nc.hcoord, rcoord=nc.rcoord, ch_ptr=nc.ch_ptr, ch_idx=nc.ch_idx,
        dpos=nc.dpos, didx=nc.didx, slot_ptr=nc.slot_ptr, slot_idx=nc.slot_idx, mu=nc.mu,
        inv_var=nc.inv_var, heights=state.heights, rates=state.rates, height=state.height,
        inv_mass=inv_mass, beta_lik=beta_lik, beta_prior=beta_prior,
        C=C, N=N, D=w.r.shape[1], dim=w.dim, calibrated=int(nc.coords.calibrated),
        clock_model=clocks.MODELS.index(model.clock), n_cal=model.calibrations.n,
        n_con=model.constraints.n, n_br=model.braces.n, br_width=ka["br_width"],
        n_slots=nc.n_slots, root_left=rl, root_right=rr, use_lik=int(nc.use_lik),
        max_depth=w.max_depth, mean_root_height=float(model.mean_root_height), rho=1.0,
        lik_const=nc.lik_const)
    for k in ("ends_q", "ends_p", "ends_g", "q_new", "p_half", "g_part", "r", "z", "q_sub",
              "q_prop", "q_ck", "p_ck", "lp", "jac", "logp", "dh", "h0", "log_w", "lw_sub",
              "sum_acc",
              "n_steps", "depth", "stop", "trn", "div", "scratch", "slots"):
        args[k] = getattr(w, k)
    return _NutsArgs(**{k: (v.data_ptr() if isinstance(v, torch.Tensor) else v)
                        for k, v in args.items()})


def _launch(name: str, w: NutsWork, device) -> None:
    fn = build.bind(f"mcmcdate_{name}_f32", (ctypes.c_void_p, ctypes.c_void_p))
    build.check(fn(ctypes.addressof(w.args), build.stream_ptr(device)), f"{name} kernel")


def _leaf_args(w: NutsWork, eps: float, dirs, u=None, u_stride: int = 0, leaf: int = 0):
    a = w.args
    a.init = int(dirs is None)
    a.eps = float(eps)
    a.dirs = None if dirs is None else dirs.data_ptr()
    a.u = None if u is None else u.data_ptr()
    a.u_stride = u_stride
    a.leaf = leaf


def _check_u(u, C: int, name: str):
    """A ``[C]`` float32 CUDA vector, maybe strided (a column of the
    doubling's draws): the kernels read ``u[c * stride]``."""
    if u.device.type != "cuda" or u.dtype != torch.float32 or tuple(u.shape) != (C,):
        raise ValueError(f"nuts_step: {name} must be a [{C}] float32 CUDA tensor")


def nuts_leapfrog_prologue(nc: NutsConsts, w: NutsWork, state, eps: float, inv_mass,
                           beta_lik, beta_prior, dirs=None, normals=None) -> None:
    """H1: one drift of every chain whose subtree is still going (``dirs``
    ``[C]`` bool: the doubling's directions), or with ``normals`` ``[C,
    dim]`` the trajectory's start (``q_new`` holds ``q0``; ``p0 = normals /
    sqrt(inv_mass)``).  Writes ``q_new``, ``p_half``, ``g_part`` (the
    gradient of ``beta_prior log prior + log Jacobian``), ``r``, ``lp`` and
    ``jac``.  The plain version for CPU tensors, the kernel for CUDA
    tensors (float32)."""
    if w.q_new.device.type == "cpu":
        nuts_leapfrog_prologue_plain(nc, w, state, eps, inv_mass, beta_lik, beta_prior, dirs,
                                     normals)
        return
    if normals is not None:
        w.args = _bind_args(nc, w, state, inv_mass, beta_lik, beta_prior)
        build.require_cuda(normals, "normals", torch.float32)
        if normals.shape != w.q_new.shape:
            raise ValueError("nuts_step: normals must be [C, dim]")
        _leaf_args(w, 0.0, None)
        w.args.normals = normals.data_ptr()
    else:
        build.require_cuda(dirs, "dirs", torch.bool)
        _leaf_args(w, eps, dirs)
    _launch("nuts_leapfrog_prologue", w, w.q_new.device)
    nuts_leapfrog_prologue.launches += 1


def nuts_leapfrog_epilogue(nc: NutsConsts, w: NutsWork, state, eps: float, inv_mass,
                           beta_lik, beta_prior, dirs=None, u_leaf=None, leaf: int = 0) -> None:
    """H2: the kick and the decisions of leaf ``leaf`` (its take uniform
    ``u_leaf`` ``[C]``, maybe a column of the doubling's draws) after H1
    and the product, or without ``dirs`` the trajectory's init (``h0``, the
    ends, the proposal, the weights and flags).  The plain version for CPU
    tensors, the kernel for CUDA tensors (float32)."""
    if w.q_new.device.type == "cpu":
        nuts_leapfrog_epilogue_plain(nc, w, state, eps, inv_mass, beta_lik, beta_prior, dirs,
                                     u_leaf, leaf)
        return
    if w.args is None:
        raise RuntimeError("nuts_leapfrog_epilogue: the trajectory was not started by H1")
    if dirs is None:
        _leaf_args(w, 0.0, None)
    else:
        build.require_cuda(dirs, "dirs", torch.bool)
        _check_u(u_leaf, w.C, "u_leaf")
        _leaf_args(w, eps, dirs, u_leaf, u_leaf.stride(0), leaf)
    _launch("nuts_leapfrog_epilogue", w, w.q_new.device)
    nuts_leapfrog_epilogue.launches += 1


def nuts_merge(w: NutsWork, inv_mass, u_merge) -> None:
    """H3: the merge after a doubling (``u_merge`` ``[C]``): the biased
    progressive replace of the proposal, the weights, the full-span U-turn
    check, ``stop`` and ``depth``, and the next subtree's reset.  The plain
    version for CPU tensors, the kernel for CUDA tensors (float32)."""
    if w.q_new.device.type == "cpu":
        nuts_merge_plain(w, inv_mass, u_merge)
        return
    if w.args is None:
        raise RuntimeError("nuts_merge: the trajectory was not started by H1")
    _check_u(u_merge, w.C, "u_merge")
    w.args.u = u_merge.data_ptr()
    w.args.u_stride = u_merge.stride(0)
    _launch("nuts_merge", w, w.q_new.device)
    nuts_merge.launches += 1


nuts_leapfrog_prologue.launches = 0
nuts_leapfrog_epilogue.launches = 0
nuts_merge.launches = 0


# ---------------------------------------------------------------------------
# Replay of a trajectory's launches through the plain versions (card checks)
# ---------------------------------------------------------------------------

# What each kernel writes, and the tolerance of each field against the plain
# version on the same inputs: the drift is the same operations (exact but
# for a last bit); the gradient, the log densities and the energy are sums
# in another order; the rest follows from them.  A field is held to the
# scale of its chain's row (max(1, max |x|)), but the gradient
# (GROUP_SCALED): each entry to the scale of its group in the chain's row
# (the chain-level coordinates, the heights, the rates), so that a rate's
# partial is not held to a height's or the rate variance's scale.  The
# chain-level partials sum a term of every node in float32 and the heights'
# a few per-node partials rounded to float32 (csrc/nuts_step.cu), so an
# entry is not held to its own size.
CHECK_TOL = {"q_new": 1e-6, "p_half": 1e-6, "g_part": 1e-4, "r": 1e-5, "lp": 1e-5, "jac": 1e-6,
             "ends_q": 1e-6, "ends_p": 1e-4, "ends_g": 1e-5, "q_ck": 1e-6, "p_ck": 1e-4,
             "logp": 1e-5, "dh": 1e-5, "h0": 1e-5, "sum_acc": 1e-5, "lw_sub": 1e-5,
             "q_sub": 1e-6, "q_prop": 1e-6, "log_w": 1e-5}
GROUP_SCALED = ("g_part", "ends_g")
# A U-turn check's dot product within this share of the sum of its terms'
# magnitudes is a tie (NutsCheck._turn_ties).
TURN_TIE = 1e-5
# The energy error and the weights formed from it are differences of
# energies, each a log density and a kinetic energy that may cancel: held
# to the scale of the chain's energies (|logp|, |h0|, |dh|).
ENERGY_SCALED = ("dh", "sum_acc", "lw_sub", "log_w")
# The gradient and what the kick forms from it, compared only where the
# state is valid: at a state of log density -inf (a negative branch, say)
# the leaf diverges and nothing reads them, and the two sides' partials of
# the terms that are -inf there differ (the plain version's autograd keeps
# log(la)'s partial of a node whose branch is negative, the kernel does
# not).
GRAD_FIELDS = ("g_part", "ends_g", "ends_p", "p_ck")
WRITES = {"prologue": ("q_new", "p_half", "g_part", "r", "lp", "jac"),
          "epilogue": ("ends_q", "ends_p", "ends_g", "q_ck", "p_ck", "logp", "dh", "h0",
                       "sum_acc", "lw_sub", "q_sub", "q_prop"),
          "merge": ("q_prop", "log_w")}
DECISIONS = {"epilogue": ("n_steps", "trn", "div"), "merge": ("stop", "depth")}


def _dot_margin(dq, p, inv_mass):
    """Each chain's ``|dq . (p inv_mass)|`` over the sum of its terms'
    magnitudes."""
    t = dq * (p * inv_mass)
    return t.sum(dim=1).abs() / torch.clamp(t.abs().sum(dim=1), min=1e-30)


def _rowscale(x):
    """Each chain's scale, ``max(1, max |x|)`` over its finite entries."""
    fin = torch.where(torch.isfinite(x), x.abs(), 0.0)
    rows = fin.reshape(fin.shape[0], -1) if fin.dim() > 1 else fin[:, None]
    return torch.clamp(rows.max(dim=1).values, min=1.0)


class NutsCheck:
    """Runs a trajectory's launches through the kernels and, from the same
    state, through the plain versions, then goes on from the kernels'
    state: every written field within :data:`CHECK_TOL` (equal where not
    finite), every decision equal but a take, or a U-turn, whose deciding
    margin is within float32 rounding.  ``coords`` (a :class:`FlatCoords`)
    gives the gradient's groups (None: one group).  ``err`` holds the
    largest error of each kernel's fields, ``field_err`` of each field,
    ``depth`` the deepest trajectory replayed."""

    def __init__(self, w: NutsWork, coords=None):
        self.w = w
        self.bounds = (0,) if coords is None else (0, coords.off_h, coords.off_r)
        self.err = {"prologue": 0.0, "epilogue": 0.0, "merge": 0.0}
        self.field_err: dict = {}
        self.ties = 0
        self.turn_ties = 0
        self.compared = 0
        self.depth = 0

    def _snap(self):
        return {k: v.clone() for k, v in vars(self.w).items() if isinstance(v, torch.Tensor)}

    def _set(self, snap):
        for k, v in snap.items():
            getattr(self.w, k).copy_(v)

    def run(self, which: str, kernel, plain, u=None, leaf: int = 0, dirs=None, inv_mass=None):
        """One launch: ``u`` the epilogue's take uniforms, ``leaf`` and
        ``dirs`` its leaf and directions, ``inv_mass`` the trajectory's
        (for the margins of the U-turn checks)."""
        before = self._snap()
        kernel()
        after_k = self._snap()
        self._set(before)
        plain()
        after_p = self._snap()
        self._set(after_k)
        for f in WRITES[which]:
            k, p = after_k[f], after_p[f]
            if f == "q_sub" or (f == "q_prop" and which == "epilogue") or not k.numel():
                continue
            fin = torch.isfinite(p)
            if f in GRAD_FIELDS:
                valid = torch.isfinite(after_p["lp"] + after_p["jac"] if which == "prologue"
                                       else after_p["logp"])
                if f in ("ends_g", "ends_p"):
                    valid = valid.expand(2, -1)
                elif f == "p_ck":
                    valid = valid.expand(p.shape[0], -1)
                k, p = k[valid], p[valid]
                if not k.numel():
                    continue
                fin = torch.isfinite(p)
            if not torch.equal(torch.isfinite(k), fin):
                bad = torch.nonzero(torch.isfinite(k) != fin)[:4].tolist()
                raise AssertionError(
                    f"nuts {which}: {f} is finite at other entries, e.g. {bad}: kernel "
                    f"{[float(k[tuple(i)]) for i in bad]}, plain "
                    f"{[float(p[tuple(i)]) for i in bad]}")
            d = torch.where(fin, (k - p).abs(), 0.0)
            if f in GROUP_SCALED:
                d = d.reshape(-1, d.shape[-1])
                pa = torch.where(fin, p.abs(), 0.0).reshape(d.shape)
                rel = torch.stack([
                    d[:, a:b].max(dim=1).values
                    / torch.clamp(pa[:, a:b].max(dim=1).values, min=1.0)
                    for a, b in zip(self.bounds, (*self.bounds[1:], d.shape[1])) if b > a
                ]).max(dim=0).values
            else:
                scale = _rowscale(self._energy(after_p) if f in ENERGY_SCALED else
                                  p.reshape(-1, p.shape[-1]) if p.dim() > 2 else p)
                d = d.reshape(-1, d.shape[-1]) if d.dim() > 2 else d
                rel = (d if d.dim() == 1 else d.max(dim=1).values) / scale
            e = float(rel.max())
            self.err[which] = max(self.err[which], e)
            self.field_err[f] = max(self.field_err.get(f, 0.0), e)
            if e > CHECK_TOL[f]:
                c = int(rel.argmax()) % k.shape[-2 if k.dim() > 1 else 0]
                raise AssertionError(
                    f"nuts {which}: {f} off its plain version by {e:.3g} "
                    f"(tolerance {CHECK_TOL[f]:g}), chain {c}: kernel "
                    f"{k.reshape(-1, k.shape[-1])[c][:6].tolist() if k.dim() > 1 else float(k[c])}"
                    f", plain "
                    f"{p.reshape(-1, p.shape[-1])[c][:6].tolist() if p.dim() > 1 else float(p[c])}")
        for f in DECISIONS.get(which, ()):
            if torch.equal(after_k[f], after_p[f]):
                continue
            turn = {"epilogue": "trn", "merge": "stop"}[which]
            if f != turn or inv_mass is None:
                raise AssertionError(f"nuts {which}: the decision {f} differs")
            self._turn_ties(which, before, after_k, after_p, leaf, dirs, inv_mass)
        if which == "epilogue" and u is not None:
            self._takes(after_k, after_p, u)
        if which == "merge":
            self.depth = max(self.depth, int(after_k["depth"].max()))
        self.compared += 1

    def _turn_ties(self, which, before, k, p, leaf, dirs, inv_mass):
        """U-turn decisions equal but where a deciding dot product is
        within :data:`TURN_TIE` of the sum of its terms' magnitudes (a
        float32 sum in another order can take either sign there)."""
        diff = k["trn" if which == "epilogue" else "stop"] != p[
            "trn" if which == "epilogue" else "stop"]
        margins = []
        if which == "merge":
            dq = before["ends_q"][1] - before["ends_q"][0]
            margins += [_dot_margin(dq, before["ends_p"][0], inv_mass),
                        _dot_margin(dq, before["ends_p"][1], inv_mass)]
        else:
            q = before["q_new"]
            p_leaf = _end(p["ends_p"], dirs)
            sgn = torch.where(dirs, 1.0, -1.0).to(q.dtype)[:, None]
            for j in range(1, _popcount(leaf ^ (leaf + 1))):
                sa = _popcount(leaf + 1 - 2 ** j)
                dq = sgn * (q - before["q_ck"][sa])
                margins += [_dot_margin(dq, before["p_ck"][sa], inv_mass),
                            _dot_margin(dq, p_leaf, inv_mass)]
        if not margins:
            raise AssertionError(f"nuts {which}: a U-turn decision differs with no check run")
        margin = torch.stack(margins).min(dim=0).values
        if bool((margin[diff] > TURN_TIE).any()):
            raise AssertionError(f"nuts {which}: a U-turn decision differs away from a tie "
                                 f"(margins {margin[diff][:4].tolist()})")
        self.turn_ties += int(diff.sum())

    @staticmethod
    def _energy(p):
        """Each chain's energy scale: ``max(|logp|, |h0|, |dh|)`` over the
        finite ones (a divergent step's kinetic energy can dwarf both log
        densities)."""
        a = [torch.where(torch.isfinite(p[f]), p[f].abs(), 0.0) for f in ("logp", "h0", "dh")]
        return torch.maximum(torch.maximum(a[0], a[1]), a[2])

    def _takes(self, k, p, u):
        """Takes (the subtree candidate moved to the leaf's position) equal
        but where the margin ``log u - (dh - lw_sub)`` is within rounding."""
        diff = (k["q_sub"] == k["q_new"]).all(dim=1) != (p["q_sub"] == p["q_new"]).all(dim=1)
        if bool(diff.any()):
            dh = torch.where(torch.isnan(p["dh"]), -math.inf, p["dh"])
            margin = (torch.log(u) - (dh - p["lw_sub"])).abs()
            tol = 1e-5 * (1.0 + self._energy(p))
            if bool((margin[diff] > tol[diff]).any()):
                raise AssertionError("nuts epilogue: a take differs away from a tie")
            self.ties += int(diff.sum())
