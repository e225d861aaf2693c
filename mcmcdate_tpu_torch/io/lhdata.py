"""Serialization of likelihood data (the ``.data`` file).

Host copy of ``mcmcdate_tpu/io/lhdata.py`` for the kinds the port runs
(that module imports the JAX likelihood module).  The JSON layout is the
same, so ``.data`` files move between the packages (and the reference):

- ``{"tag": "FullS", "contents": [mu, sigmaInvRows, logDetSigma]}``
- ``{"tag": "UnivariateS", "contents": [mu, variances]}``
- ``{"tag": "NoLikelihoodS", "contents": []}``

``SparseS`` and ``BandedS`` files raise ``NotImplementedError``.
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
    elif data.kind == mvn.UNIVARIATE:
        obj = {
            "tag": "UnivariateS",
            "contents": [data.mu.tolist(), data.variances.tolist()],
        }
    elif data.kind in (mvn.SPARSE, mvn.BANDED):
        raise NotImplementedError(mvn.NOT_PORTED.format(data.kind))
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
    if tag == "UnivariateS":
        mu, vs = contents
        return mvn.LikelihoodData.univariate(np.asarray(mu), np.asarray(vs))
    if tag in ("SparseS", "BandedS"):
        raise NotImplementedError(mvn.NOT_PORTED.format(tag[:-1].lower()))
    raise ValueError(f"load_data: Could not decode data file {path} (tag {tag!r}).")
