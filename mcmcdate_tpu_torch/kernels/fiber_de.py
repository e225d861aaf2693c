"""F2 ``fiber_de``: one half-update of the red-black fiber differential
evolution.

Replaces the XLA-compiled ``half_update`` of the JAX ``make_fiber_de``
(``mcmcdate_tpu/engine/ensemble.py:81-128``), the move of ``run
--fiber-de``.  The chains are two halves; each chain ``i`` of the active
half (``act0 .. act0 + m``) proposes from two distinct donors ``a != b`` of
the frozen half (``oth0 + a``, ``oth0 + b``):

    h' = h + g (h_a - h_b),   r'_j = r_j t_j / t'_j   (every time x rate kept)

with ``g = (u_jump < jump_p ? gamma_jump : gamma_small) exp(gamma_jitter
z)``, valid when every non-root span ``t'_j`` stays above 1e-7, and is
accepted when ``log u_acc < log prior(h', r') - log prior(h, r) + log_jac``,
``log_jac = sum_j log(t_j / t'_j)`` over the non-root branches.  The draws
(``a``, ``b``, the jump uniform, the jitter normal, the accept uniform)
are injected.  The likelihood is invariant and never evaluated.

The plain version is a line-by-line port of the JAX ``half_update``
(``DatingModel.log_prior`` of both states).  The kernel
(``csrc/fiber_de.cu``) runs a CTA per active chain: the proposal, spans,
rates and Jacobian a node a thread, the whole log prior of both states from
``csrc/prior_terms.cuh``'s device functions in block sums of a fixed order,
thread 0's decision and the write-back of the chain's heights and rates.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..models.state import FIELDS, State
from . import build
from .fiber_slide import model_args, state_args

EPS = 1e-7  # the smallest proposed span of a valid proposal


class DEOut(NamedTuple):
    """One half-update's outputs per active chain ``[m]`` (``h_prop`` and
    ``r_prop`` ``[m, N]``)."""

    accept: torch.Tensor   # bool
    g: torch.Tensor        # the step
    dlp: torch.Tensor      # log prior delta + log_jac
    log_jac: torch.Tensor
    h_prop: torch.Tensor
    r_prop: torch.Tensor


def fiber_de_plain(model, state: State, act0: int, m: int, oth0: int, a, b, u_jump, z, u_acc,
                   gamma_small: float, jump_p: float = 0.2, gamma_jump: float = 1.0,
                   gamma_jitter: float = 0.1, g=None) -> DEOut:
    """Plain PyTorch version of :func:`fiber_de` (updates ``state`` in
    place): the JAX ``half_update`` on injected draws; ``g`` ``[m]`` replaces
    the step formed from ``u_jump`` and ``z`` where given (a replay of the
    kernel's)."""
    h, r = state.heights, state.rates
    dtype = h.dtype
    act = slice(act0, act0 + m)
    parent = model.topo.parent_t.clamp(min=0)  # entry 0 (the root) is unused
    ha = h[oth0 + a.long()]
    hb = h[oth0 + b.long()]
    if g is None:
        base = torch.where(u_jump < jump_p, torch.as_tensor(gamma_jump, dtype=dtype),
                           torch.as_tensor(gamma_small, dtype=dtype))
        g = base * torch.exp(gamma_jitter * z)
    h0, r0 = h[act].clone(), r[act].clone()  # the write-back below changes h[act]
    hp = h0 + g[:, None] * (ha - hb)
    t0 = h0[:, parent] - h0
    t1 = hp[:, parent] - hp
    pos = t1 > EPS
    valid = torch.all(pos[:, 1:], dim=1)
    safe = torch.where(pos, t1, torch.ones_like(t1))
    ratio = torch.where(pos, t0 / safe, torch.ones_like(t1))
    ratio[:, 0] = 1.0  # the stem rate entry is unused
    rp = r0 * ratio
    log_jac = torch.sum(torch.log(torch.where(pos[:, 1:], ratio[:, 1:],
                                              torch.ones_like(ratio[:, 1:]))), dim=1)
    cur = State(**{f: getattr(state, f)[act] for f in FIELDS})
    prop = cur.replace(heights=hp, rates=rp)
    dlp = model.log_prior(prop) - model.log_prior(cur) + log_jac
    accept = valid & (torch.log(u_acc) < dlp)
    h[act] = torch.where(accept[:, None], hp, h0)
    r[act] = torch.where(accept[:, None], rp, r0)
    return DEOut(accept, g, dlp, log_jac, hp, rp)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_PTRS = ("parent", "is_leaf", "cal_node", "cal_lower", "cal_lower_pm", "cal_upper",
         "cal_upper_pm", "con_young", "con_old", "con_pm", "br_node", "br_sd",
         "heights", "rates", "birth", "death", "height", "rate_mean", "rate_var",
         "a", "b", "u_jump", "z", "u_acc",
         "accept", "g", "dlp", "log_jac", "h_prop", "r_prop")
_INTS = ("N", "C", "act0", "m", "oth0", "clock_model", "n_cal", "n_con", "n_br", "br_width")
_FLOATS = ("mean_root_height", "rho", "gamma_small", "jump_p", "gamma_jump", "gamma_jitter",
           "eps")


class _DEArgs(ctypes.Structure):
    """``DEArgs`` of ``csrc/fiber_de.cu``, field by field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_float) for k in _FLOATS])


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    if build.bind("mcmcdate_de_args_size", ())() != ctypes.sizeof(_DEArgs):
        raise RuntimeError("fiber_de: the kernel's argument layout does not match the wrapper's")


def fiber_de(model, state: State, act0: int, m: int, oth0: int, a, b, u_jump, z, u_acc,
             gamma_small: float, jump_p: float = 0.2, gamma_jump: float = 1.0,
             gamma_jitter: float = 0.1) -> DEOut:
    """One half-update on the chains ``act0 .. act0 + m`` of ``state``, in
    place, with the donors of the frozen half ``oth0 + a`` and ``oth0 + b``
    (``a``, ``b`` int32 ``[m]``, ``b != a``), the jump uniforms ``u_jump``,
    jitter normals ``z`` and accept uniforms ``u_acc`` ``[m]``.  Returns a
    :class:`DEOut`.  The plain version runs for CPU tensors, kernel F2 for
    CUDA tensors (float32)."""
    if state.heights.device.type == "cpu":
        return fiber_de_plain(model, state, act0, m, oth0, a, b, u_jump, z, u_acc, gamma_small,
                              jump_p, gamma_jump, gamma_jitter)
    C, N = state.heights.shape
    args = dict(model_args(model), **state_args(state))
    for name, t in (("u_jump", u_jump), ("z", z), ("u_acc", u_acc)):
        build.require_cuda(t, name, torch.float32)
    for name, t in (("a", a), ("b", b)):
        build.require_cuda(t, name, torch.int32)
    if not (0 <= act0 and act0 + m <= C and 0 <= oth0 < C):
        raise ValueError(f"fiber_de: halves [{act0}, {act0 + m}) and from {oth0} of {C} chains")
    dev = state.heights.device
    out = DEOut(torch.empty(m, dtype=torch.bool, device=dev),
                *(torch.empty(m, dtype=torch.float32, device=dev) for _ in range(3)),
                *(torch.empty((m, N), dtype=torch.float32, device=dev) for _ in range(2)))
    args.update(a=a, b=b, u_jump=u_jump, z=z, u_acc=u_acc, **out._asdict(), C=C, act0=act0,
                m=m, oth0=oth0, gamma_small=float(gamma_small), jump_p=float(jump_p),
                gamma_jump=float(gamma_jump), gamma_jitter=float(gamma_jitter), eps=EPS)
    _check_layout()
    st = _DEArgs(**{k: (v.data_ptr() if isinstance(v, torch.Tensor) else v)
                    for k, v in args.items() if v is not None})
    fn = build.bind("mcmcdate_fiber_de_f32", (ctypes.c_void_p, ctypes.c_void_p))
    build.check(fn(ctypes.addressof(st), build.stream_ptr(dev)), "fiber_de kernel")
    fiber_de.launches += 1
    return out


fiber_de.launches = 0
