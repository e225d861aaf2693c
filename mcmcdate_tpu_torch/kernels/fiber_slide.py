"""F1 ``fiber_slide``: one colour class of the fiber node-slide.

Replaces the XLA-compiled class step of ``FastSweeps._fiber_slide_move``
(``mcmcdate_tpu/engine/fast_sweep.py:2016-2113``), the optional phase of
``run --fiber-slide``.  For each chain and each node ``v`` of the class
(no two of them tree-adjacent or sharing a constraint or a brace:
``engine.fast_sweep.fiber_slide_plan``): a new height drawn uniformly
between the node's oldest child ``lo`` and its parent, ``h' = lo + u (h_p -
lo)`` with ``u`` in ``[1e-6, 1)``; its stem rate times ``f_s = (h_p - h)/(h_p
- h')`` and each child's times ``f_c = (h - h_c)/(h' - h_c)``, so that every
branch distance stays; the terms the class's owner map gives ``v`` (the
birth-death and clock terms of ``v`` and of its children, and the
calibrations, constraints and braces it owns), their delta summed with a
NaN delta counted as -inf; the decision ``log u_acc < beta_prior sum +
log_jac`` with ``log_jac = log f_s + sum log f_c``; and on accept the
in-place write-back of the height, the rates and the owned terms.  The
likelihood is invariant: ``d``, ``z``, ``q`` and ``y`` are not touched.

The plain version mirrors the JAX step line by line: the whole proposed
state's term vector (``DatingModel.log_prior_terms``, kernel K1 on the
card) and the deltas summed by owner into a ``[C, m + 1]`` buffer.  The
kernel (``csrc/fiber_slide.cu``) evaluates only each node's owned terms with
``csrc/prior_terms.cuh``'s device functions through views of the proposed
state, so a term is bitwise K1's for the same state.  What bounds it on
the H100: the birth-death terms' double-precision exp and log (three a
binary node) and the gathers of a node's heights, rates and terms; see the
source.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import clocks
from . import build

NEG_INF = -math.inf


@dataclass
class FiberClass:
    """One colour class of the fiber plan on the device: its nodes ``idx``,
    their parents ``par`` and children ``ch`` ``[m, KC]`` (-1 pad), the
    children flattened (``ch_row``, ``ch_col``, ``ch_idx``), the term owner
    map ``owner`` ``[T]`` (``m``: no class node) and, for the kernel, each
    node's owned term rows in ascending order as ``own_rows[own_ptr[j]:
    own_ptr[j + 1]]``."""

    idx: torch.Tensor
    par: torch.Tensor
    ch: torch.Tensor
    ch_row: torch.Tensor
    ch_col: torch.Tensor
    ch_idx: torch.Tensor
    owner: torch.Tensor
    own_ptr: torch.Tensor
    own_rows: torch.Tensor

    @property
    def m(self) -> int:
        return self.idx.shape[0]

    @classmethod
    def of(cls, plan: dict, n_terms: int, device) -> "FiberClass":
        """A class of :func:`~..engine.fast_sweep.fiber_slide_plan` on
        ``device`` (int32 arrays)."""
        owner = np.asarray(plan["owner"])
        if owner.shape != (n_terms,):
            raise ValueError(f"fiber plan: owner map of {owner.shape}, expected ({n_terms},)")
        m = len(plan["idx"])
        rows = np.nonzero(owner < m)[0]
        order = np.argsort(owner[rows], kind="stable")  # by node, rows ascending within
        ptr = np.concatenate([[0], np.cumsum(np.bincount(owner[rows], minlength=m))])

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device).contiguous()

        return cls(*(i32(plan[k]) for k in ("idx", "par", "ch", "ch_row", "ch_col", "ch_idx",
                                            "owner")), i32(ptr), i32(rows[order]))


class FiberOut(NamedTuple):
    """What a class step decided, per chain and class node ``[C, m]``."""

    accept: torch.Tensor     # bool
    log_alpha: torch.Tensor  # beta_prior * (owned delta) + log_jac
    h_new: torch.Tensor      # the proposed height


def fiber_slide_plain(model, state, terms, cls: FiberClass, u, u_acc, beta_prior=None,
                      count=None) -> FiberOut:
    """Plain PyTorch version of :func:`fiber_slide` (updates in place): the
    JAX ``_fiber_slide_move``'s class body on injected draws."""
    h, r = state.heights, state.rates
    idx, par, ch = cls.idx, cls.par, cls.ch
    C, m = h.shape[0], cls.m
    chm = ch >= 0
    chc = torch.clamp(ch, min=0)
    hv = h[:, idx]                                       # [C, m]
    hp = h[:, par]
    hch = h[:, chc]                                      # [C, m, KC]
    lo = torch.where(chm, hch, 0.0).amax(dim=-1)
    hn = lo + u * (hp - lo)
    f_s = (hp - hv) / (hp - hn)
    dt_c_new = hn[:, :, None] - hch
    f_c = torch.where(chm, (hv[:, :, None] - hch) / dt_c_new, 1.0)
    log_jac = torch.log(f_s) + torch.sum(
        torch.where(chm, torch.log(torch.where(chm, f_c, 1.0)), 0.0), dim=-1)
    f_ce = f_c[:, cls.ch_row, cls.ch_col]                # [C, E]
    h_new = h.clone()
    h_new[:, idx] = hn
    r_new = r.clone()
    r_new[:, idx] = r[:, idx] * f_s
    r_new[:, cls.ch_idx] = r[:, cls.ch_idx] * f_ce
    terms_n = model.log_prior_terms(state.replace(heights=h_new, rates=r_new))
    dterm = terms_n - terms
    dsum = torch.zeros((C, m + 1), dtype=terms.dtype, device=terms.device).index_add_(
        1, cls.owner, torch.where(torch.isnan(dterm), NEG_INF, dterm))
    d_pr = dsum[:, :m] if beta_prior is None else beta_prior[:, None] * dsum[:, :m]
    la = d_pr + log_jac
    ok = torch.log(u_acc) < la  # NaN compares False: reject
    h[:, idx] = torch.where(ok, hn, hv)
    r[:, idx] = r[:, idx] * torch.where(ok, f_s, 1.0)
    r[:, cls.ch_idx] = r[:, cls.ch_idx] * torch.where(ok[:, cls.ch_row], f_ce, 1.0)
    ok_pad = torch.cat([ok, torch.zeros((C, 1), dtype=torch.bool, device=ok.device)], dim=1)
    terms.copy_(torch.where(ok_pad[:, cls.owner], terms_n, terms))
    if count is not None:
        count += ok.sum().to(count.dtype)
    return FiberOut(ok, la, hn)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_PTRS = ("parent", "is_leaf", "cal_node", "cal_lower", "cal_lower_pm", "cal_upper",
         "cal_upper_pm", "con_young", "con_old", "con_pm", "br_node", "br_sd",
         "heights", "rates", "birth", "death", "height", "rate_mean", "rate_var", "terms",
         "idx", "par", "ch", "own_ptr", "own_rows", "u", "u_acc", "beta_prior",
         "accept", "log_alpha", "h_new", "count")
_INTS = ("N", "C", "T", "m", "KC", "clock_model", "n_cal", "n_con", "n_br", "br_width")
_FLOATS = ("mean_root_height", "rho")


class _FiberArgs(ctypes.Structure):
    """``FiberArgs`` of ``csrc/fiber_slide.cu``, field by field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_float) for k in _FLOATS])


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    if build.bind("mcmcdate_fiber_args_size", ())() != ctypes.sizeof(_FiberArgs):
        raise RuntimeError("fiber_slide: the kernel's argument layout does not match the "
                           "wrapper's")


def model_args(model) -> dict:
    """The model's arrays and sizes as ``ModelArgs`` of
    ``csrc/prior_terms.cuh`` reads them (F1 and F2)."""
    ka = model.prior_kernel_arrays
    return dict(zip(_PTRS[2:7], ka["cal"]), **dict(zip(_PTRS[7:10], ka["con"])),
                **dict(zip(_PTRS[10:12], ka["br"])), parent=ka["parent"],
                is_leaf=ka["is_leaf"], N=model.topo.n,
                clock_model=clocks.MODELS.index(model.clock), n_cal=model.calibrations.n,
                n_con=model.constraints.n, n_br=model.braces.n, br_width=ka["br_width"],
                mean_root_height=float(model.mean_root_height), rho=1.0)


def state_args(state) -> dict:
    """A chain batch's fields, checked (float32 CUDA tensors)."""
    out = {}
    for k in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        build.require_cuda(getattr(state, k), k, torch.float32)
        out[k] = getattr(state, k)
    return out


def fiber_slide(model, state, terms, cls: FiberClass, u, u_acc, beta_prior=None,
                count=None) -> FiberOut:
    """One colour class of the fiber node-slide on every chain, in place:
    ``state`` heights and rates, ``terms`` ``[C, T]``.  ``u`` ``[C, m]`` in
    ``[1e-6, 1)`` places each node's new height in its interval, ``u_acc``
    ``[C, m]`` are the accept uniforms, ``beta_prior`` ``[C]`` the chains'
    prior temperature (None: 1) and ``count`` (int32 ``[1]``, or None)
    receives the class's accepts.  Returns a :class:`FiberOut`.  The plain
    version runs for CPU tensors, kernel F1 for CUDA tensors (float32)."""
    if terms.device.type == "cpu":
        return fiber_slide_plain(model, state, terms, cls, u, u_acc, beta_prior, count)
    C, N = state.heights.shape
    m = cls.m
    args = dict(model_args(model), **state_args(state))
    for name, t in (("terms", terms), ("u", u), ("u_acc", u_acc)):
        build.require_cuda(t, name, torch.float32)
    for name in ("idx", "par", "ch", "own_ptr", "own_rows"):
        build.require_cuda(getattr(cls, name), name, torch.int32)
    if u.shape != (C, m) or u_acc.shape != (C, m):
        raise ValueError(f"fiber_slide: draws of {tuple(u.shape)} and {tuple(u_acc.shape)}, "
                         f"expected ({C}, {m})")
    if count is not None:
        build.require_cuda(count, "count", torch.int32)
    dev = terms.device
    out = FiberOut(torch.empty((C, m), dtype=torch.bool, device=dev),
                   torch.empty((C, m), dtype=torch.float32, device=dev),
                   torch.empty((C, m), dtype=torch.float32, device=dev))
    args.update(terms=terms, idx=cls.idx, par=cls.par, ch=cls.ch, own_ptr=cls.own_ptr,
                own_rows=cls.own_rows, u=u, u_acc=u_acc,
                beta_prior=build.beta_arg(beta_prior, C, dev), accept=out.accept,
                log_alpha=out.log_alpha, h_new=out.h_new, count=count, C=C,
                T=terms.shape[1], m=m, KC=cls.ch.shape[1])
    _check_layout()
    st = _FiberArgs(**{k: (v.data_ptr() if isinstance(v, torch.Tensor) else v)
                       for k, v in args.items() if v is not None})
    fn = build.bind("mcmcdate_fiber_slide_f32", (ctypes.c_void_p, ctypes.c_void_p))
    build.check(fn(ctypes.addressof(st), build.stream_ptr(dev)), "fiber_slide kernel")
    fiber_slide.launches += 1
    return out


fiber_slide.launches = 0
