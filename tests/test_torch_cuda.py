"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes.  Needs an NVIDIA card (sm_90a) with nvcc; skipped
elsewhere.  On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from mcmcdate_tpu_torch import synthetic
from mcmcdate_tpu_torch.kernels.accept_select import accept_select, accept_select_plain
from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms, prior_terms_plain
from mcmcdate_tpu_torch.kernels.whiten import range_rows, whiten, whiten_plain
from mcmcdate_tpu_torch.models.state import FIELDS, State
from mcmcdate_tpu_torch.ops import clocks
from mcmcdate_tpu_torch.ops.heights import distances_internal

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(clock=clocks.UNCORRELATED_GAMMA):
    model, batch = synthetic.build(40, 96, device="cuda", clock=clock)
    g = np.random.default_rng(0)
    return model, batch.replace(
        birth=torch.as_tensor(g.uniform(0.2, 3, 96), dtype=torch.float32, device="cuda"),
        rate_var=torch.as_tensor(g.uniform(1e-3, 1, 96), dtype=torch.float32, device="cuda"))


@pytest.mark.parametrize("clock", clocks.MODELS)
def test_prior_terms_kernel(card, clock):
    model, batch = _model(clock)
    before = prior_terms.launches
    k = prior_terms(model, batch)
    p = prior_terms_plain(model, batch)
    assert prior_terms.launches == before + 1
    assert torch.equal(torch.isfinite(k), torch.isfinite(p))
    fin = torch.isfinite(p)
    assert torch.all((k[fin] - p[fin]).abs() <= 1e-5 + 1e-5 * p[fin].abs())


def test_whiten_kernel(card):
    model, batch = _model()
    d = distances_internal(batch, model.topo).contiguous()
    L, mu = model.chol_internal_t, model.mu_internal_t
    y, _ = whiten_plain(d, L, sub=mu)
    D = d.shape[1]
    for rows in (model.rows_all, torch.as_tensor([2, 0, D, 5], dtype=torch.int32, device=card),
                 torch.as_tensor(range_rows(3, 64, D), dtype=torch.int32, device=card)):
        for kw in (dict(sub=mu), dict(y=y), dict(sub=mu, y=y, minus_y=True)):
            dk, rk = whiten(d, L, rows=rows, **kw)
            dp, rp = whiten_plain(d, L, rows=rows, **kw)
            # float32 sums in another order: errors scale with the operands
            # (y and the quadratic form), not with a result that may cancel
            # to zero (dy = y' - y = 0 in the last case).
            scale = max(1.0, float(dp.abs().max()), float(y.abs().max()))
            assert (dk - dp).abs().max() <= 1e-5 * scale
            q = float((y * y).sum(1).max())
            assert (rk - rp).abs().max() <= 1e-5 * max(1.0, float(rp.abs().max()), q)


def test_accept_select_kernel(card):
    model, old = _model()
    new = old.replace(heights=old.heights * 0.999, rates=old.rates * 1.01,
                      birth=old.birth * 1.1)
    terms, terms2 = model.log_prior_terms(old), model.log_prior_terms(new)
    terms2[::5, 3] = -math.inf
    g = torch.Generator(device=card).manual_seed(1)
    C = terms.shape[0]
    log_mhg = torch.randn(C, generator=g, device=card) - (terms2 - terms).sum(1).nan_to_num()
    u = torch.rand(C, generator=g, device=card)
    outs = []
    for fn in (accept_select, accept_select_plain):
        st = State(**{f: getattr(old, f).clone() for f in FIELDS})
        nw = new.replace(death=st.death)
        t = terms.clone()
        acc = torch.zeros((C, 3), dtype=torch.int32, device=card)
        a = fn(t, terms2, log_mhg, u, st, nw, acc, 1)
        outs.append((a, st, t, acc))
    (ak, sk, tk, acck), (ap, sp, tp, accp) = outs
    assert torch.equal(ak, ap) and 0 < int(ak.sum()) < C
    assert torch.equal(acck, accp)
    assert torch.equal(tk.nan_to_num(), tp.nan_to_num())
    for f in FIELDS:
        assert torch.equal(getattr(sk, f), getattr(sp, f))
