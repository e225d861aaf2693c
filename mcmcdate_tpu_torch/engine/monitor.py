"""Monitor output: params / timetree / ratetree / prior files + stdout.

Host copy of ``mcmcdate_tpu/engine/monitor.py`` (that module imports the
JAX model); the files it writes are the same, byte for byte.

File layout mirrors the reference's monitor system (app/Definitions.hs:288-417,
app/Monitor.hs; files are named ``<analysis>.<monitor>.monitor`` as consumed
by scripts/analyze:40-42):

- ``<an>.params.monitor``: Iteration, the five scalar parameters, one column
  per calibration (absolute node height), per constraint (height delta,
  positive when honoured), per brace (height variance).
- ``<an>.timetree.monitor``: absolute time tree, Newick per row.
- ``<an>.ratetree.monitor``: relative rate tree, Newick per row.
- ``<an>.prior.monitor``: decomposed log prior (calibrations/constraints/
  braces, birth-death, relaxed clock).

Monitors fire every ``period`` iterations (2 in the reference).
"""

from __future__ import annotations

import os
from typing import IO, Dict, Optional

import numpy as np

from ..models.dating import DatingModel


def _fmt(x: float) -> str:
    return f"{x:.8g}"


class MonitorWriter:
    """Streams monitor rows to the reference-style files."""

    def __init__(self, model: DatingModel, analysis_name: str, out_dir: str = ".",
                 period: int = 2, stdout_period: int = 100, log=print):
        self.model = model
        self.period = period
        self.stdout_period = stdout_period
        self.log = log
        base = os.path.join(out_dir, analysis_name)
        self._files: Dict[str, IO] = {}
        self._base = base
        self._header_written = False

    def open(self, mode="w"):
        for name in ("params", "timetree", "ratetree", "prior"):
            self._files[name] = open(f"{self._base}.{name}.monitor", mode)
        if mode == "w":
            self._write_headers()
        return self

    def _write_headers(self):
        m = self.model
        cols = [
            "Iteration",
            "TimeBirthRate",
            "TimeDeathRate",
            "TimeHeight",
            "RateMean",
            "RateVariance",
        ]
        for i in range(m.calibrations.n):
            nm = m.calibrations.names[i] if m.calibrations.names else str(i)
            cols.append(f"Calibration.{nm}")
        for i in range(m.constraints.n):
            nm = m.constraints.names[i] if m.constraints.names else str(i)
            cols.append(f"Constraint.{nm}")
        for i in range(m.braces.n):
            nm = m.braces.names[i] if m.braces.names else str(i)
            cols.append(f"Brace.{nm}.variance")
        self._files["params"].write("\t".join(cols) + "\n")
        self._files["timetree"].write("Iteration\tTimeTree\n")
        self._files["ratetree"].write("Iteration\tRateTree\n")
        self._files["prior"].write(
            "Iteration\tPriorCsKsBs\tPriorBirthDeath\tPriorRelaxedMolecularClock\n"
        )

    def write_rows(self, start_iteration: int, rows: Dict[str, np.ndarray]):
        """``rows`` holds stacked per-sweep arrays from the device collector:
        scalars [T], heights [T, N], rates [T, N], prior components [T]."""
        m = self.model
        topo = m.topo
        T = len(rows["birth"])
        for t in range(T):
            it = start_iteration + t + 1
            if it % self.period != 0:
                continue
            h_abs = float(rows["height"][t])
            heights = rows["heights"][t]
            vals = [
                str(it),
                _fmt(rows["birth"][t]),
                _fmt(rows["death"][t]),
                _fmt(h_abs),
                _fmt(rows["rate_mean"][t]),
                _fmt(rows["rate_var"][t]),
            ]
            for i in range(m.calibrations.n):
                vals.append(_fmt(heights[m.calibrations.node[i]] * h_abs))
            for i in range(m.constraints.n):
                d = (heights[m.constraints.old[i]] - heights[m.constraints.young[i]]) * h_abs
                vals.append(_fmt(d))
            for i in range(m.braces.n):
                idx = [int(x) for x in m.braces.node[i] if x >= 0]
                hs = heights[idx] * h_abs
                vals.append(_fmt(hs.var(ddof=1)))
            self._files["params"].write("\t".join(vals) + "\n")
            self._files["timetree"].write(
                f"{it}\t" + newick_from_arrays(topo, heights * h_abs, None) + "\n"
            )
            self._files["ratetree"].write(
                f"{it}\t" + newick_from_arrays(topo, None, rows["rates"][t]) + "\n"
            )
            self._files["prior"].write(
                f"{it}\t{_fmt(rows['lp_cal'][t])}\t{_fmt(rows['lp_bd'][t])}\t"
                f"{_fmt(rows['lp_clock'][t])}\n"
            )
            if it % self.stdout_period == 0:
                self.log(
                    f"iter {it}: posterior={rows['lp_post'][t]:.3f} "
                    f"birth={rows['birth'][t]:.3f} death={rows['death'][t]:.3f} "
                    f"height={h_abs:.3f} rateMean={rows['rate_mean'][t]:.3f}"
                )

    def flush(self):
        for f in self._files.values():
            f.flush()

    def close(self):
        for f in self._files.values():
            f.close()


_TEMPLATE_CACHE: Dict[int, list] = {}


def _newick_template(topo) -> list:
    """Static Newick skeleton for a topology: a list of string fragments
    interleaved with integer node ids marking branch-length slots.  Built
    iteratively (no recursion limit on deep caterpillar trees) and cached —
    per-row rendering then only formats the numbers."""
    tmpl = _TEMPLATE_CACHE.get(id(topo))
    if tmpl is not None:
        return tmpl
    parts: list = []
    stack = [(0, 0)]
    while stack:
        i, ci = stack[-1]
        nc = int(topo.n_children[i])
        if nc and ci == 0:
            parts.append("(")
        if ci < nc:
            if ci:
                parts.append(",")
            stack[-1] = (i, ci + 1)
            stack.append((int(topo.children[i, ci]), 0))
            continue
        if nc:
            parts.append(")")
        name = topo.names[i]
        if name:
            parts.append(name)
        parts.append(i)  # branch slot
        stack.pop()
    parts.append(";")
    _TEMPLATE_CACHE[id(topo)] = parts
    return parts


def newick_from_arrays(topo, heights: Optional[np.ndarray], rates: Optional[np.ndarray]) -> str:
    """Newick string from either node heights (branch = h_par - h) or branch
    values (rates).  Mirrors monitorLengthTree (lib/Mcmc/Tree/Monitor.hs)."""
    if heights is not None:
        b = heights[np.asarray(topo.parent)] - heights
    else:
        b = np.asarray(rates, float)
    b = np.asarray(b, float)
    b[0] = 0.0
    return "".join(
        p if isinstance(p, str) else f":{b[p]:.8g}"
        for p in _newick_template(topo)
    )
