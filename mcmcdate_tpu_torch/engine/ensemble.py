"""Cross-chain ensemble moves along the likelihood fiber: the fiber
differential evolution of ``run --fiber-de``.

Port of ``mcmcdate_tpu/engine/ensemble.py`` (its module docstring gives the
move's derivation).  For a chain ``i`` of the active half, with distinct
chains ``a`` and ``b`` of the frozen complementary half and a step ``g``,

    h' = h_i + g (h_a - h_b),   r'_j = r_j t_j / t'_j   (every time x rate held)

so the likelihood is invariant and never evaluated; the Hastings ratio is
the prior delta plus ``sum_j log(t_j / t'_j)`` over the non-root branches.
The halves are updated in turn (red-black), each half-update a valid move on
the product ensemble.  The step is ter Braak's mixture: with probability
``JUMP_P`` the mode jump ``GAMMA_JUMP``, else ``2.38 / sqrt(2 d)`` with ``d``
the free height coordinates, each times ``exp(GAMMA_JITTER N(0, 1))``.  A
half-update is kernel F2 ``fiber_de`` on the card (``kernels/fiber_de.py``),
its plain version on the CPU; the draws come from the caller's
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.fiber_de import fiber_de
from ..models.dating import DatingModel
from ..models.state import State

# ter Braak's step mixture (the JAX make_fiber_de's defaults, the only ones
# its callers use): the mode jump's probability and size, the jitter's scale.
JUMP_P, GAMMA_JUMP, GAMMA_JITTER = 0.2, 1.0, 0.1


class FiberDE:
    """The red-black fiber-DE round of a model (the JAX ``make_fiber_de``):
    ``move(batch, gen)`` updates ``batch`` (``C >= 4`` chains) in place and
    returns the round's acceptance over both half-updates, a 0-dim tensor
    on the batch's device (no synchronisation)."""

    def __init__(self, model: DatingModel):
        self.model = model
        n_free = max(int(np.sum(~np.asarray(model.topo.is_leaf))) - 1, 1)
        self.gamma_small = 2.38 / np.sqrt(2.0 * n_free)

    @staticmethod
    def draws(gen, m: int, n_oth: int, dtype, device) -> tuple:
        """One half-update's draws ``(a, b, u_jump, z, u_acc)`` ``[m]``: the
        donors ``a`` uniform over the frozen half and ``b`` uniform over the
        rest (int32), the jump uniforms, the jitter normals and the accept
        uniforms (at least the smallest normal float, as the JAX draw)."""
        a = torch.randint(0, n_oth, (m,), generator=gen, dtype=torch.int32, device=device)
        b0 = torch.randint(0, n_oth - 1, (m,), generator=gen, dtype=torch.int32, device=device)
        b = torch.where(b0 >= a, b0 + 1, b0)
        u_jump = torch.rand(m, generator=gen, dtype=dtype, device=device)
        z = torch.randn(m, generator=gen, dtype=dtype, device=device)
        u_acc = torch.rand(m, generator=gen, dtype=dtype, device=device)
        return a, b, u_jump, z, u_acc.clamp_(min=torch.finfo(dtype).tiny)

    def half_update(self, batch: State, act0: int, m: int, oth0: int, draws):
        """One half-update (F2) of chains ``act0 .. act0 + m`` from the
        frozen half starting at ``oth0``; returns its :class:`~..kernels.
        fiber_de.DEOut`."""
        return fiber_de(self.model, batch, act0, m, oth0, *draws, self.gamma_small, JUMP_P,
                        GAMMA_JUMP, GAMMA_JITTER)

    def __call__(self, batch: State, gen):
        C = batch.n_chains
        if C < 4:
            raise ValueError(f"fiber DE needs at least 4 chains, got {C}")
        h = C // 2
        dt, dev = batch.heights.dtype, batch.heights.device
        # The first half [0, C/2) from the second, then the second from the
        # first (the JAX move's order).
        n_acc = 0
        for act0, m, oth0, n_oth in ((0, h, h, C - h), (h, C - h, 0, h)):
            out = self.half_update(batch, act0, m, oth0, self.draws(gen, m, n_oth, dt, dev))
            n_acc = n_acc + out.accept.sum()
        return n_acc.to(dt) / C
