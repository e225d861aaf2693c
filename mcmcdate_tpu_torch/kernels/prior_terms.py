"""K1 ``prior_terms``: the model's flat log-prior term vector.

Replaces the XLA-compiled ``DatingModel.log_prior_terms`` of the JAX package
(``mcmcdate_tpu/models/dating.py:131``, through ``ops/birth_death.py:89``,
``ops/clocks.py:100`` and ``ops/node_priors.py:153``).  It runs at every
ticket of the sequential sweep and at every sweep start.  On the H100 it is
bound by the per-node special functions (exp, log, lgamma), not by bytes;
the kernel (``csrc/prior_terms.cu``) fuses all four term blocks into one
pass with one block per chain and the chain's heights in shared memory, so
no intermediate reaches device memory.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import clocks
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = (
    (_P,) * 7  # heights, rates, birth, death, height, rate_mean, rate_var
    + (_P, _P)  # parent, is_leaf
    + (_I, _I, _I, _I, _F, _F)  # C, N, T, clock_model, mean_root_height, rho
    + (_P,) * 5 + (_I,)  # calibrations
    + (_P,) * 3 + (_I,)  # constraints
    + (_P, _P, _I, _I)  # braces
    + (_P, _P)  # terms, stream
)


def prior_terms_plain(model, state):
    """Plain PyTorch version: the four term blocks concatenated, ``[C, T]``."""
    return torch.cat(
        [model.term_scalars(state), model.term_bd(state),
         model.term_clock(state), model.term_nodes(state)],
        dim=1,
    )


def kernel_arrays(model) -> dict:
    """The model's static arrays as the kernel reads them (int32, uint8 and
    float32 tensors on the model's device; None where a set is empty)."""
    dev = model.device

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev).contiguous()

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()

    cal, con, br = model.calibrations, model.constraints, model.braces
    out = dict(
        parent=i32(model.topo.parent),
        is_leaf=torch.as_tensor(np.asarray(model.topo.is_leaf, np.uint8), device=dev),
        cal=(i32(cal.node), f32(cal.lower), f32(cal.lower_pm), f32(cal.upper),
             f32(cal.upper_pm)) if cal.n else (None,) * 5,
        con=(i32(con.young), i32(con.old), f32(con.pm)) if con.n else (None,) * 3,
        br=(i32(br.node), f32(br.sd)) if br.n else (None, None),
        br_width=int(np.asarray(br.node).shape[1]) if br.n else 0,
    )
    return out


def prior_terms(model, state):
    """``[C, T]`` log prior terms of ``state`` under ``model``: the plain
    version for CPU tensors, kernel K1 for CUDA tensors (float32)."""
    if state.heights.device.type == "cpu":
        return prior_terms_plain(model, state)
    arrays = model.prior_kernel_arrays
    C, N = state.heights.shape
    for name in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        build.require_cuda(getattr(state, name), name, torch.float32)
    T = sum(model.term_block_sizes)
    terms = torch.empty((C, T), dtype=torch.float32, device=state.heights.device)
    fn = build.bind("mcmcdate_prior_terms_f32", _ARGTYPES)
    p = build.ptr
    err = fn(
        p(state.heights), p(state.rates), p(state.birth), p(state.death), p(state.height),
        p(state.rate_mean), p(state.rate_var), p(arrays["parent"]), p(arrays["is_leaf"]),
        C, N, T, clocks.MODELS.index(model.clock), float(model.mean_root_height), 1.0,
        *map(p, arrays["cal"]), model.calibrations.n,
        *map(p, arrays["con"]), model.constraints.n,
        *map(p, arrays["br"]), model.braces.n, arrays["br_width"],
        p(terms), build.stream_ptr(terms.device),
    )
    build.check(err, "prior_terms kernel")
    prior_terms.launches += 1
    return terms


prior_terms.launches = 0
