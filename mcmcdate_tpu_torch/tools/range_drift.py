"""The carried distances ``d`` of FastSweeps' range phase against a fresh
evaluation after every block, on the CPU (the kernels' plain versions).

    python -m mcmcdate_tpu_torch.tools.range_drift [--taxa 60] [--dtype float64]
        [--chains 16] [--sweeps 3]

Each sweep runs the sequential, glob and point phases as ``sweep_once``
does, then the range phase block by block (``FastSweeps.range_phase``'s
loop), and prints the largest ``|d - distances_internal(state)|``, relative
to the largest distance, after the glob and point phases and after any
range block, with that block's (kind, row bucket, block, tickets).  At
float64 the error stays at rounding level; at float32 it grows with the
blocks a distance lies in (each accepted block updates ``d += (f - 1)
d``).
"""

from __future__ import annotations

import argparse

import torch

from .. import synthetic
from ..engine import fast_sweep as TF, proposals as TP
from ..engine.mh import chain_beta
from ..ops.dists import standard_gamma
from ..ops.heights import distances_internal


def _err(carry, model):
    """The largest ``|d - fresh|`` relative to the largest ``|fresh|``."""
    fresh = distances_internal(carry.batch, model.topo)
    return float((carry.d - fresh).abs().max() / fresh.abs().max())


def replay(taxa: int, dtype, chains: int, sweeps: int, seed: int = 1, log=print) -> list:
    """Per sweep ``(after glob, after point, (worst after a block, where))``."""
    model, batch = synthetic.build(taxa, chains, dtype=dtype, device="cpu", seed=seed)
    table = TP.build_proposal_table(model.topo, model.braces, False)
    fs = TF.FastSweeps(model, table)
    tuning = torch.ones((chains, table.n_proposals), dtype=dtype)
    gen, host_gen = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    carry = fs.init_carry(batch)
    carry.beta = chain_beta(None, chains, dtype, batch.heights.device)
    y = model.whitened_residual_internal(carry.batch)
    out = []
    for s in range(sweeps):
        fs.seq_phase(carry, y, tuning, host_gen, gen)
        carry.z, carry.q = fs._zq_from_y(y)
        fs.glob_phase(carry, tuning, gen)
        e_glob = _err(carry, model)
        fs.point_phase(carry, tuning, gen)
        e_point = _err(carry, model)
        worst = (0.0, None)
        for key, steps in fs.range_t.items():
            k = key[0]
            if k == TP.K_SCALE_SUBTREE_RATE:
                rows, sd = fs.range_gamma[key]
                shape = sd / tuning.index_select(1, rows)
            off = 0
            for b, sx in enumerate(steps):
                S = sx["rows"].shape[0]
                if k == TP.K_SCALE_SUBTREES_CONTRA:
                    fs.range_contra_step(carry, tuning, sx, fs._rand(carry, gen, chains, S),
                                         fs._rand(carry, gen, chains, S))
                else:
                    draw = (standard_gamma(shape[:, off:off + S], gen)
                            if k == TP.K_SCALE_SUBTREE_RATE else fs._rand(carry, gen, chains, S))
                    off += S
                    fs.range_lik_step(k, carry, tuning, sx, draw,
                                      fs._rand(carry, gen, chains, S))
                e = _err(carry, model)
                if e > worst[0]:
                    worst = (e, dict(kind=k, bucket=key[1], block=b, tickets=S))
        y = fs._y_from_d(carry.d)
        log(f"sweep {s}: after glob {e_glob:.3g}, after point {e_point:.3g}, worst after a "
            f"range block {worst[0]:.3g} at {worst[1]}")
        out.append((e_glob, e_point, worst))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--taxa", type=int, default=60)
    ap.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--sweeps", type=int, default=3)
    a = ap.parse_args(argv)
    replay(a.taxa, getattr(torch, a.dtype), a.chains, a.sweeps)


if __name__ == "__main__":
    main()
