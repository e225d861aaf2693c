"""The PyTorch port's FastSweeps planner against the JAX package's: the
same mega-step, range-block and global-family arrays and the same
sequential leftover rows, on an uncalibrated, a calibrated (with a
constraint and a brace) and a multifurcating model."""

import dataclasses

import numpy as np
import pytest

from mcmcdate_tpu.engine.fast_sweep import plan_batches as j_plan
from mcmcdate_tpu_torch.engine import fast_sweep as TF

from torch_fast_common import Case


def _slotted(spec):
    """The JAX planner's slide term rows with each child's rows at the slots
    of the step's new terms (birth-death at 2+j, clock at 2+KC+j): it packs
    them to the front, which differs for a node with fewer than KC
    children."""
    t = np.asarray(spec.t_rows)
    ch = np.asarray(spec.ch)
    kc = ch.shape[-1]
    if t.shape[-1] < 2 * (1 + kc):  # branch-rate steps: one clock row
        return t
    out = t.copy()
    n = (ch >= 0).sum(-1)
    for m, b in zip(*np.nonzero(n < kc)):
        k = int(n[m, b])
        out[m, b, 2:2 * (1 + kc)] = -1
        out[m, b, 2:2 + k] = t[m, b, 2:2 + k]
        out[m, b, 2 + kc:2 + kc + k] = t[m, b, 2 + k:2 + 2 * k]
    return out


def _same(a, b, what):
    assert type(a).__name__ == type(b).__name__, what
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "t_rows" and hasattr(b, "ch"):
            y = _slotted(b)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, (what, f.name)
            np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f.name}")
        else:
            assert x == y, (what, f.name)


@pytest.mark.parametrize("shape, priors", [("binary", False), ("binary", True),
                                           ("multi", False)])
def test_plan_matches_jax(shape, priors):
    case = Case("full", shape=shape, priors=priors)
    ref = j_plan(case.jm, case.table)
    port = TF.plan_batches(case.pm, case.ptable)
    assert list(port.specs) == list(ref.specs)
    for k in ref.specs:
        _same(port.specs[k], ref.specs[k], f"specs[{k}]")
    assert list(port.range_specs) == list(ref.range_specs)
    for k in ref.range_specs:
        _same(port.range_specs[k], ref.range_specs[k], f"range_specs[{k}]")
    assert list(port.glob_groups) == list(ref.glob_groups)
    for k in ref.glob_groups:
        _same(port.glob_groups[k], ref.glob_groups[k], f"glob_groups[{k}]")
    np.testing.assert_array_equal(port.seq_rows, ref.seq_rows)
    for f in ("kind", "node", "aux", "par", "weight", "dim", "root_jac", "tickets", "d_class",
              "d_lo", "didx", "prior_class"):
        np.testing.assert_array_equal(getattr(port.seq_table, f), getattr(ref.seq_table, f))
    assert port.seq_table.names == ref.seq_table.names
    # Every batched family and a sequential remainder are present.
    assert ref.specs and ref.range_specs and ref.glob_groups
    if priors:
        assert len(ref.seq_rows) > 0
        assert any(s.cal_lo.shape[-1] for s in ref.specs.values())
    if shape == "multi":
        assert max(s.ch.shape[-1] for s in ref.specs.values()) > 2
        # Some step holds a node with fewer children than its KC.
        assert any(not np.array_equal(_slotted(s), s.t_rows) for s in ref.specs.values())
