"""K1 ``prior_terms``: the model's flat log-prior term vector.

Replaces the XLA-compiled ``DatingModel.log_prior_terms`` of the JAX package
(``mcmcdate_tpu/models/dating.py:131``, through ``ops/birth_death.py:89``,
``ops/clocks.py:100`` and ``ops/node_priors.py:153``).  It runs at every
carry's start (``init_carry``), a few times a run.  On the H100 it is bound
by the per-node special functions (double-precision exp and log, float log
and lgamma), then by bytes; the kernel (``csrc/prior_terms.cu``) forms each
chain's birth-death and clock constants once, then walks the term vector in
passes of one code path each (the fixed entries, the inner nodes' and the
leaves' birth-death terms, the clock terms, the node terms) over the node
lists :func:`prior_plan` builds here, several chains a CTA, so no
intermediate reaches device memory.
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
    + (_P, _I, _I)  # bd_nodes (node, parent pairs), n_inner, n_leaf
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


def prior_plan(topo) -> dict:
    """K1's node lists: ``inner`` the non-root inner nodes and ``leaves``
    the leaves (int32, ascending), whose birth-death terms the kernel
    evaluates in a pass each; its clock pass takes the non-root nodes
    1 .. N-1 and its fixed pass the root's entries, which needs the root at
    node 0 (the pre-order of ``FlatTopology``)."""
    parent = np.asarray(topo.parent)
    is_leaf = np.asarray(topo.is_leaf, bool)
    if parent[0] >= 0 or (parent[1:] < 0).any():
        raise ValueError("K1 takes a topology whose root, and only root, is node 0")
    nodes = np.arange(1, len(parent), dtype=np.int32)
    return dict(inner=nodes[~is_leaf[1:]], leaves=nodes[is_leaf[1:]])


def kernel_arrays(model) -> dict:
    """The model's static arrays as the kernel reads them (int32, uint8 and
    float32 tensors on the model's device; None where a set is empty), with
    :func:`prior_plan`'s node lists as one array ``bd_nodes`` of (node,
    parent) pairs (the inner nodes, then the leaves) and their counts."""
    dev = model.device
    plan = prior_plan(model.topo)
    nodes = np.concatenate([plan["inner"], plan["leaves"]])

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev).contiguous()

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()

    cal, con, br = model.calibrations, model.constraints, model.braces
    out = dict(
        parent=i32(model.topo.parent),
        is_leaf=torch.as_tensor(np.asarray(model.topo.is_leaf, np.uint8), device=dev),
        bd_nodes=i32(np.stack([nodes, np.asarray(model.topo.parent)[nodes]], axis=1)),
        n_inner=len(plan["inner"]),
        n_leaf=len(plan["leaves"]),
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
        p(arrays["bd_nodes"]), arrays["n_inner"], arrays["n_leaf"], C, N, T,
        clocks.MODELS.index(model.clock), float(model.mean_root_height), 1.0,
        *map(p, arrays["cal"]), model.calibrations.n,
        *map(p, arrays["con"]), model.constraints.n,
        *map(p, arrays["br"]), model.braces.n, arrays["br_width"],
        p(terms), build.stream_ptr(terms.device),
    )
    build.check(err, "prior_terms kernel")
    prior_terms.launches += 1
    return terms


prior_terms.launches = 0
