"""Serialization of likelihood data (the ``.data`` file).

Host copy of ``mcmcdate_tpu/io/lhdata.py`` (that module imports the JAX
likelihood module).  The JSON layout is the
same, so ``.data`` files move between the packages (and the reference):

- ``{"tag": "FullS", "contents": [mu, sigmaInvRows, logDetSigma]}``
- ``{"tag": "SparseS", "contents": [mu, [[[i, j], v], ...], logDetSigma]}``
- ``{"tag": "UnivariateS", "contents": [mu, variances]}``
- ``{"tag": "NoLikelihoodS", "contents": []}``
- ``{"tag": "BandedS", "contents": [mu, bandChol, logDetSigma, perm]}``
  (the JAX package's own kind, which the reference does not have)
"""

from __future__ import annotations

import json

import numpy as np

from ..ops import mvn


def save_data(path: str, data: mvn.LikelihoodData) -> None:
    if data.kind == mvn.NONE:
        obj = {"tag": "NoLikelihoodS", "contents": []}
    elif data.kind == mvn.FULL:
        obj = {
            "tag": "FullS",
            "contents": [
                data.mu.tolist(),
                data.precision.tolist(),
                data.log_det_sigma,
            ],
        }
    elif data.kind == mvn.SPARSE:
        assoc = data.precision_assoc
        if assoc is None:
            assoc = dense_to_assoc(data.precision)
        obj = {
            "tag": "SparseS",
            "contents": [
                data.mu.tolist(),
                [[[int(i), int(j)], float(v)] for (i, j), v in assoc],
                data.log_det_sigma,
            ],
        }
    elif data.kind == mvn.UNIVARIATE:
        obj = {
            "tag": "UnivariateS",
            "contents": [data.mu.tolist(), data.variances.tolist()],
        }
    elif data.kind == mvn.BANDED:
        obj = {
            "tag": "BandedS",
            "contents": [
                data.mu.tolist(),
                data.band_chol.tolist(),
                data.log_det_sigma,
                np.asarray(data.band_perm).tolist(),
            ],
        }
    else:
        raise ValueError(f"save_data: unknown kind {data.kind!r}")
    with open(path, "w") as fh:
        json.dump(obj, fh)


def load_data(path: str) -> mvn.LikelihoodData:
    with open(path) as fh:
        obj = json.load(fh)
    tag = obj.get("tag")
    contents = obj.get("contents", [])
    if tag == "NoLikelihoodS":
        return mvn.LikelihoodData.none()
    if tag == "FullS":
        mu, rows, log_det = contents
        return mvn.LikelihoodData.full(np.asarray(mu), np.asarray(rows), log_det)
    if tag == "SparseS":
        mu, assoc, log_det = contents
        mu = np.asarray(mu)
        n = len(mu)
        prec = np.zeros((n, n))
        pairs = []
        for (i, j), v in ((tuple(ij), v) for ij, v in assoc):
            prec[i, j] = v
            pairs.append(((i, j), v))
        return mvn.LikelihoodData.sparse(mu, prec, log_det, assoc=pairs)
    if tag == "UnivariateS":
        mu, vs = contents
        return mvn.LikelihoodData.univariate(np.asarray(mu), np.asarray(vs))
    if tag == "BandedS":
        mu, band, log_det, perm = contents
        return mvn.LikelihoodData.banded(np.asarray(mu), np.asarray(band), log_det,
                                         np.asarray(perm))
    raise ValueError(f"load_data: Could not decode data file {path} (tag {tag!r}).")


def dense_to_assoc(m: np.ndarray, eps: float = 1e-8):
    """Association list of entries with |value| > eps (``toAssocMatrix``,
    app/Main.hs:142-155), in row-major order as the JAX package's loop
    writes it."""
    m = np.asarray(m)
    n, mm = m.shape
    if n != mm:
        raise ValueError("dense_to_assoc: Matrix not square.")
    ii, jj = np.nonzero(np.abs(m) > eps)
    return [((int(i), int(j)), float(v)) for i, j, v in zip(ii, jj, m[ii, jj])]
