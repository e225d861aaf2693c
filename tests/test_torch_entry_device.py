"""The port's library entry points run on the card unless the caller asks
for the CPU: without ``device`` they raise on a machine with no card (the
error names ``device="cpu"``), never falling back to the CPU; with
``device="cpu"`` and no ``dtype`` they give float64.  The card is hidden
by patching ``torch.cuda.is_available``, so the test means the same on any
machine."""

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch.engine import checkpoint
from mcmcdate_tpu_torch.models import DatingModel, State, from_numpy, init_state
from mcmcdate_tpu_torch.models.state import FIELDS
from mcmcdate_tpu_torch.ops import mvn
from mcmcdate_tpu_torch.tree import DeviceTopology
from mcmcdate_tpu_torch.tree.flat import FlatTopology
from mcmcdate_tpu_torch.utils.device import NoCardError
from mcmcdate_tpu_torch.utils.simulate import random_ultrametric_tree


def _fixture(tmp_path):
    rng = np.random.default_rng(0)
    tree = random_ultrametric_tree(rng, 6)
    topo = FlatTopology.from_tree(tree)
    k = topo.n - 2
    lik = mvn.LikelihoodData.univariate(rng.uniform(0.1, 0.5, k), rng.uniform(0.01, 0.1, k))
    arrays = {f: rng.uniform(0.5, 1.0, (2, topo.n) if f in ("heights", "rates") else 2)
              for f in FIELDS}
    # A float64 checkpoint on disk for checkpoint.load.
    checkpoint.save("e", State.from_arrays(arrays, device="cpu"),
                    np.ones((2, 3)), np.zeros(2, np.uint32), 1, 3, out_dir=str(tmp_path))
    return tree, topo, lik, arrays


# Each entry point, called with the keyword arguments given; returns a
# tensor it made (a float one, which must be float64 on the CPU, but for
# DeviceTopology's int64 index arrays).
ENTRIES = {
    "from_numpy": lambda tree, topo, lik, arrays, tmp, **kw: from_numpy(
        topo, lik, arrays, **kw)[1].heights,
    "State.from_arrays": lambda tree, topo, lik, arrays, tmp, **kw: State.from_arrays(
        arrays, **kw).birth,
    "init_state": lambda tree, topo, lik, arrays, tmp, **kw: init_state(
        tree, topo, 2, **kw).heights,
    "checkpoint.load": lambda tree, topo, lik, arrays, tmp, **kw: checkpoint.load(
        "e", in_dir=str(tmp), **kw)[0].heights,
    "make_log_likelihood": lambda tree, topo, lik, arrays, tmp, **kw: mvn.make_log_likelihood(
        lik, **kw)(torch.zeros((2, topo.n - 2), dtype=torch.float32)),
    "DeviceTopology": lambda tree, topo, lik, arrays, tmp, **kw: DeviceTopology(
        topo, **kw).parent_t,
    "DatingModel": lambda tree, topo, lik, arrays, tmp, **kw: DatingModel(
        topo=topo, likelihood=lik, **kw).inv_sd_internal_t,
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_default_device_needs_a_card(entry, tmp_path, no_card):
    args = _fixture(tmp_path)
    with pytest.raises(NoCardError, match='device="cpu"'):
        ENTRIES[entry](*args, tmp_path)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_cpu_gives_float64(entry, tmp_path, no_card):
    out = ENTRIES[entry](*_fixture(tmp_path), tmp_path, device="cpu")
    assert out.device.type == "cpu"
    assert out.dtype == (torch.int64 if entry == "DeviceTopology" else torch.float64)
