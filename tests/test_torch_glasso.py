"""The port's graphical lasso (``mcmcdate_tpu_torch/utils/glasso.py``)
against the JAX package's at float64 on the CPU: the host BCD copy bitwise,
the ADMM loop through the plain versions of A1-A3 within 1e-12, and each
plain version against the JAX body's expression."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcdate_tpu.utils import glasso as JG
from mcmcdate_tpu_torch.kernels import glasso_admm as K
from mcmcdate_tpu_torch.utils import glasso as TG


# Both ADMMs run the same float64 iteration; eigh and the product differ in
# their last bits between LAPACK builds (signs of eigenvectors, sums'
# order), and the loop amplifies that by less than a few thousand ulps.
ADMM_TOL = 1e-12


def _corr(p, n, seed):
    """A correlation matrix of standardized samples of a random sparse-ish
    precision (``tests/test_prepare_io.py``'s ADMM data at p = 40)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(p, p)) / np.sqrt(p)
    truth = a @ a.T + np.eye(p)
    x = rng.multivariate_normal(np.zeros(p), np.linalg.inv(truth), size=n)
    _, _, xn = JG.scale_data(x)
    return np.cov(xn, rowvar=False)


def _jax_admm(monkeypatch, S, rho, tol):
    """The JAX ADMM's (W, Theta) and its iteration count (the while_loop's
    last carry entry)."""
    its = []
    real = jax.lax.while_loop

    def counted(cond, body, init):
        out = real(cond, body, init)
        its.append(int(out[-1]))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counted)
    W, Theta = JG.graphical_lasso_admm(S, rho, tol=tol)
    monkeypatch.setattr(jax.lax, "while_loop", real)
    return W, Theta, its[0]


def test_bcd_copy_is_bitwise():
    S = _corr(12, 300, 3)
    for rho in (0.05, 0.2):
        Wj, Tj = JG.graphical_lasso(S, rho)
        Wt, Tt = TG.graphical_lasso(S, rho)
        assert np.array_equal(Wj, Wt) and np.array_equal(Tj, Tt)
    x = np.random.default_rng(1).normal(size=(50, 6))
    for a, b in zip(JG.scale_data(x), TG.scale_data(x)):
        assert np.array_equal(a, b)
    sd = np.abs(x[0]) + 0.5
    assert np.array_equal(JG.rescale_cov(sd, S[:6, :6]), TG.rescale_cov(sd, S[:6, :6]))
    assert np.array_equal(JG.rescale_precision(sd, S[:6, :6]),
                          TG.rescale_precision(sd, S[:6, :6]))


@pytest.mark.parametrize("p, n, rho, tol", ((40, 2000, 0.05, 1e-8), (120, 600, 0.1, 1e-6)),
                         ids=("p40", "p120"))
def test_admm_matches_jax(monkeypatch, p, n, rho, tol):
    S = _corr(p, n, 7)
    Wj, Tj, its = _jax_admm(monkeypatch, S, rho, tol)
    stats = {}
    launches = [k.launches for k in K.KERNELS]
    Wt, Tt = TG.graphical_lasso_admm(S, rho, tol=tol, device="cpu", stats=stats)
    # The CPU route runs the plain versions: no kernel launch.
    assert [k.launches for k in K.KERNELS] == launches
    assert stats["iterations"] == its
    assert np.array_equal(Tj == 0, Tt == 0)
    assert 0 < (Tt == 0).mean() < 1
    assert np.abs(Tt - Tj).max() <= ADMM_TOL
    assert np.abs(Wt - Wj).max() <= ADMM_TOL


def test_admm_loop_state():
    """``admm_solve`` stops where the JAX loop's test does and hands back a
    state a next iteration can take (U not yet divided by the last fac)."""
    S = torch.as_tensor(_corr(30, 400, 5), dtype=torch.float64)
    run = TG.admm_solve(S, 0.1, tol=1e-6)
    eps = 1e-6 * 30
    assert run.r <= eps and run.s <= eps
    assert run.fac in (0.5, 1.0, 2.0)
    again = TG.admm_solve(S, 0.1, tol=1e-6, max_iter=run.iterations - 1)
    assert again.iterations == run.iterations - 1
    assert again.r > eps or again.s > eps


def _sym(rng, p):
    a = rng.normal(size=(p, p))
    return 0.5 * (a + a.T)


def test_plain_versions_match_jax_expressions():
    rng = np.random.default_rng(11)
    p, t, fac, alpha, rho = 23, 1.7, 0.5, 1.5, 0.1
    Z, U, S = _sym(rng, p), rng.normal(size=(p, p)), _sym(rng, p)
    T = torch.as_tensor
    # A1: U / fac, then jnp.linalg.eigh's symmetrised input t (Z - U) - S.
    Ut = T(U.copy())
    A = K.admm_shift_plain(T(Z), Ut, T(S), t, fac)
    Uj = jnp.asarray(U) / fac
    Bj = t * (jnp.asarray(Z) - Uj) - jnp.asarray(S)
    np.testing.assert_array_equal(Ut.numpy(), np.asarray(Uj))
    np.testing.assert_array_equal(A.numpy(), np.asarray((Bj + Bj.T) / 2))
    assert torch.equal(A, A.mT)
    # A2: Q * theta, on both layouts eigh may return.
    lam, Q = np.linalg.eigh(_sym(rng, p))
    thj = (jnp.asarray(lam) + jnp.sqrt(jnp.asarray(lam) * jnp.asarray(lam) + 4.0 * t)) / (2.0 * t)
    want = np.asarray(jnp.asarray(Q) * thj)
    for q in (T(Q), T(np.asfortranarray(Q))):
        np.testing.assert_array_equal(K.admm_eig_scale_plain(T(lam), q, t).numpy(), want)
    # A3: the relaxed soft threshold, in place, and the two sums.
    Tm = rng.normal(size=(p, p)) * 0.3
    Zt, Ut = T(Z.copy()), T(U.copy())
    rs = K.admm_update_plain(T(Tm), Zt, Ut, alpha, rho / t).numpy()
    Trj = alpha * jnp.asarray(Tm) + (1.0 - alpha) * jnp.asarray(Z)
    a = Trj + jnp.asarray(U)
    Zj = jnp.sign(a) * jnp.maximum(jnp.abs(a) - rho / t, 0.0)
    np.testing.assert_array_equal(Zt.numpy(), np.asarray(Zj))
    np.testing.assert_array_equal(Ut.numpy(), np.asarray(jnp.asarray(U) + Trj - Zj))
    assert (Zt.numpy() == 0).any()
    r = float(jnp.linalg.norm(jnp.asarray(Tm) - Zj))
    s = float(jnp.linalg.norm(Zj - jnp.asarray(Z)))
    np.testing.assert_allclose(np.sqrt(rs), [r, s], rtol=1e-14)


def test_admm_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from mcmcdate_tpu_torch.utils.device import NoCardError

    with pytest.raises(NoCardError):
        TG.graphical_lasso_admm(np.eye(3), 0.1)
