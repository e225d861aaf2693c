"""Model definitions: state space and composed densities."""

from __future__ import annotations

import dataclasses

from ..ops import clocks, mvn, node_priors
from .dating import DatingModel  # noqa: F401
from .state import State, init_state, is_valid_state  # noqa: F401


def _copy(cls, obj):
    """An instance of the port's dataclass ``cls`` with the same-named
    fields read from ``obj`` (the JAX package's host dataclass)."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
                  if hasattr(obj, f.name)})


def from_numpy(topo, likelihood, state: dict, *, clock=clocks.UNCORRELATED_GAMMA,
               calibrations=None, constraints=None, braces=None,
               mean_root_height=1.0, dtype=None, device="cuda"):
    """The port's ``(DatingModel, State)`` from host data: a
    ``FlatTopology``, a likelihood description with the fields of
    ``LikelihoodData``, the calibration/constraint/brace sets (any objects
    with the ``*Set`` fields, e.g. the JAX package's), and a dict of the
    state arrays ``heights, rates, birth, death, height, rate_mean,
    rate_var`` with or without a leading chain axis.  On the card unless
    ``device`` says otherwise (no card: :class:`~..utils.device.NoCardError`);
    ``dtype=None``: float32 on a CUDA device, float64 on the CPU."""
    model = DatingModel(
        topo=topo,
        likelihood=_copy(mvn.LikelihoodData, likelihood),
        clock=clock,
        calibrations=(node_priors.CalibrationSet.empty() if calibrations is None
                      else _copy(node_priors.CalibrationSet, calibrations)),
        constraints=(node_priors.ConstraintSet.empty() if constraints is None
                     else _copy(node_priors.ConstraintSet, constraints)),
        braces=(node_priors.BraceSet.empty() if braces is None
                else _copy(node_priors.BraceSet, braces)),
        mean_root_height=mean_root_height,
        device=device,
        dtype=dtype,
    )
    return model, State.from_arrays(state, dtype=model.dtype, device=model.device)
