"""``cascade_seed``: one rung's seeding in the stepping-stone cascade, chain
``j``'s row copied to chain ``j + 1`` in every field of the chain state.

Replaces the re-seeding step of the JAX package's ``annealed_cascade``
(``mcmcdate_tpu/engine/stepping_stone.py:66-94``: ``jax.tree.map(lambda
x: x.at[j + 1].set(x[j]), batch)`` over the State leaves).  The port's
cascade is a host loop over the rungs (``engine/stepping_stone.py``), and
each rung's seeding is one launch of this kernel.

On the H100 it is bound by its launch: the bytes are one chain's row of
each field, ``(2 N + 5)`` floats read and written (about 2.2 KB at 136
taxa, a nanosecond at the memory's rate).  The kernel
(``csrc/cascade_seed.cu``) takes every field in one launch, a CTA per
field, 16-byte words where the rows allow.
"""

from __future__ import annotations

import ctypes

from ..models.state import FIELDS
from . import build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def cascade_seed_plain(batch, j: int) -> None:
    """Plain version of :func:`cascade_seed`: the per-field copy, in place."""
    for name in FIELDS:
        x = getattr(batch, name)
        x[j + 1].copy_(x[j])


def cascade_seed(batch, j: int) -> None:
    """Copy chain ``j``'s row of every field of the chain state ``batch``
    (a ``State``) to chain ``j + 1``, in place.  The plain version runs for
    CPU tensors, the kernel for CUDA tensors (contiguous float32)."""
    C = batch.heights.shape[0]
    if not 0 <= j < C - 1:
        raise ValueError(f"cascade_seed: row {j} has no next row among {C} chains")
    if batch.heights.device.type == "cpu":
        cascade_seed_plain(batch, j)
        return
    fields = [getattr(batch, name) for name in FIELDS]
    for name, x in zip(FIELDS, fields):
        build.require_cuda(x, name)
        if x.shape[0] != C or x.element_size() != 4:
            raise ValueError(f"cascade_seed: {name} must be [{C}, ...] of 4-byte entries")
    n = len(fields)
    bases = (ctypes.c_void_p * n)(*[x.data_ptr() for x in fields])
    rows = (ctypes.c_longlong * n)(*[x[0].numel() * 4 for x in fields])
    dev = batch.heights.device
    err = build.bind("mcmcdate_cascade_seed_f32", _ARGTYPES)(
        ctypes.addressof(bases), ctypes.addressof(rows), n, j, build.stream_ptr(dev))
    build.check(err, "cascade_seed kernel")
    cascade_seed.launches += 1


cascade_seed.launches = 0
