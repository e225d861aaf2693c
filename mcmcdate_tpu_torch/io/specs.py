"""Loading and validation of calibrations, constraints, and braces.

Host copy of ``mcmcdate_tpu/io/specs.py`` (that module imports the JAX
node-prior module for its ``*Set`` classes); same formats and checks.

File formats match the reference exactly:

- Calibrations CSV (Calibration.hs:287-301):
  ``Name,LeafA,LeafB,Lower,LowerPM,Upper,UpperPM`` (either bound+mass pair
  may be empty).
- Calibrations from an MCMCTree-style Newick file with ``L(..)/U(..)/B(..)``
  node annotations (CalibrationFromTree.hs:28-116).
- Constraints CSV (Constraint.hs:275-305):
  ``Name,YoungA,YoungB,OldA,OldB,PM``.
- Braces JSON (Brace.hs:115-157):
  ``[{"braceDataName": .., "braceDataNodes": [[leafA, leafB], ..],
  "braceDataStandardDeviation": ..}]``.

Validation mirrors the reference's: duplicate calibrations warn or error
(HandleProblematicCalibrations, Calibration.hs:249-283); constraints are
checked for identity, redundancy (dropped), and conflict (error)
(Constraint.hs:306-374); braces with ancestor/duplicate nodes error
(Brace.hs:82-113).
"""

from __future__ import annotations

import csv
import io as _io
import json
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.node_priors import BraceSet, CalibrationSet, ConstraintSet
from ..tree.flat import FlatTopology
from ..tree.rose import Node, mrca_path, read_one_newick


class SpecError(ValueError):
    pass


def _mrca_index(topo: FlatTopology, tree: Node, leaves: Sequence[str], what: str) -> int:
    try:
        path = mrca_path(tree, leaves)
    except ValueError as e:
        raise SpecError(f"{what}: {e}") from e
    return topo.node_of_path(path)


# ---------------------------------------------------------------------------
# Calibrations
# ---------------------------------------------------------------------------


def load_calibrations_csv(
    path_or_text: str,
    tree: Node,
    topo: FlatTopology,
    *,
    ignore_problematic: bool = False,
    log=print,
    is_text: bool = False,
) -> CalibrationSet:
    text = path_or_text if is_text else open(path_or_text).read()
    rows = list(csv.reader(_io.StringIO(text)))
    if not rows:
        raise SpecError("loadCalibrations: No calibrations found.")
    # Header row (HasHeader in the reference decoder).
    rows = rows[1:]
    recs = []
    for row in rows:
        if not row or all(not c.strip() for c in row):
            continue
        row = [c.strip() for c in row] + [""] * (7 - len(row))
        name, la, lb, lo, lo_pm, hi, hi_pm = row[:7]
        recs.append((name, la, lb, _maybe_float(lo), _maybe_float(lo_pm),
                     _maybe_float(hi), _maybe_float(hi_pm)))
    if not recs:
        raise SpecError("loadCalibrations: No calibrations found.")
    return _build_calibrations(recs, tree, topo, ignore_problematic, log)


def _maybe_float(s: str) -> Optional[float]:
    s = s.strip()
    return float(s) if s else None


_ANNOT_RE = re.compile(
    r"^(?:"
    r"L\((?P<l1>[^,)]+)(?:,(?P<l2>[^,)]+))?(?:,(?P<l3>[^,)]+))?(?:,(?P<l4>[^,)]+))?\)"
    r"|U\((?P<u1>[^,)]+)(?:,(?P<u2>[^,)]+))?\)"
    r"|B\((?P<b1>[^,)]+),(?P<b2>[^,)]+)(?:,(?P<b3>[^,)]+))?(?:,(?P<b4>[^,)]+))?\)"
    r")$"
)


def load_calibrations_tree(
    path: str,
    tree: Node,
    topo: FlatTopology,
    *,
    ignore_problematic: bool = False,
    log=print,
) -> CalibrationSet:
    """Parse MCMCTree-style node annotations (see MCMCTree manual p. 49).

    The annotated node is resolved as the MRCA of the leftmost and rightmost
    leaf of the annotated clade; the default probability mass is 0.01
    (CalibrationFromTree.hs:92-116).
    """
    cal_tree = read_one_newick(path)
    recs = []

    def leftmost(n: Node) -> str:
        while n.children:
            n = n.children[0]
        return n.name

    def rightmost(n: Node) -> str:
        while n.children:
            n = n.children[-1]
        return n.name

    def walk(n: Node):
        m = _ANNOT_RE.match(n.name or "")
        if m:
            g = m.groupdict()
            a, b = leftmost(n), rightmost(n)
            name = f"{a}-{b}"
            if g["l1"] is not None:
                # L(lower[, cauchyC[, cauchyP[, pm]]]) — Cauchy params ignored.
                lo = float(g["l1"])
                pm = float(g["l4"]) if g["l4"] is not None else 0.01
                recs.append((name, a, b, lo, pm, None, None))
            elif g["u1"] is not None:
                hi = float(g["u1"])
                pm = float(g["u2"]) if g["u2"] is not None else 0.01
                recs.append((name, a, b, None, None, hi, pm))
            else:
                lo, hi = float(g["b1"]), float(g["b2"])
                pm_lo = float(g["b3"]) if g["b3"] is not None else 0.01
                pm_hi = float(g["b4"]) if g["b4"] is not None else 0.01
                recs.append((name, a, b, lo, pm_lo, hi, pm_hi))
        for c in n.children:
            walk(c)

    walk(cal_tree)
    if not recs:
        raise SpecError(f"loadCalibrationsFromTree: no calibrations found in file: {path}")
    return _build_calibrations(recs, tree, topo, ignore_problematic, log)


def _build_calibrations(recs, tree, topo, ignore_problematic, log) -> CalibrationSet:
    nodes, lowers, lower_pms, uppers, upper_pms, names, paths = [], [], [], [], [], [], []
    for name, la, lb, lo, lo_pm, hi, hi_pm in recs:
        if lo is None and lo_pm is not None:
            raise SpecError(f"{name}: Lower probability mass given but no lower boundary.")
        if lo is not None and lo_pm is None:
            raise SpecError(f"{name}: Lower boundary given but no lower probability mass.")
        if hi is None and hi_pm is not None:
            raise SpecError(f"{name}: Upper probability mass given but no upper boundary.")
        if hi is not None and hi_pm is None:
            raise SpecError(f"{name}: Upper boundary given but no upper probability mass.")
        if lo is None and hi is None:
            raise SpecError(f"{name}: No boundaries provided.")
        if lo is not None and hi is not None and lo >= hi:
            raise SpecError(f"{name}: Lower boundary larger equal upper boundary.")
        for pm in (lo_pm, hi_pm):
            if pm is not None and not (0 < pm < 1):
                raise SpecError(f"{name}: Probability mass {pm} out of range (0, 1).")
        if lo is not None and lo <= 0:
            raise SpecError(f"{name}: Zero or negative lower boundary.")
        if hi is not None and hi <= 0:
            raise SpecError(f"{name}: Zero or negative upper boundary.")
        idx = _mrca_index(topo, tree, [la, lb], f"calibration {name}")
        nodes.append(idx)
        lowers.append(lo if lo is not None else 0.0)
        lower_pms.append(lo_pm if lo_pm is not None else 1.0)
        uppers.append(hi if hi is not None else np.inf)
        upper_pms.append(hi_pm if hi_pm is not None else 1.0)
        names.append(name)
        paths.append(topo.paths[idx])
    # Duplicate detection by node (Calibration.hs:266-283).
    seen = {}
    dups = []
    for i, nd in enumerate(nodes):
        if nd in seen:
            dups.append((names[seen[nd]], names[i]))
        else:
            seen[nd] = i
    if dups:
        msg = "Duplicate/conflicting/redundant calibrations have been detected: " + str(dups)
        if ignore_problematic:
            log("WARNING: " + msg)
        else:
            raise SpecError("loadCalibrations: " + msg)
    else:
        log("No duplicate/conflicting/redundant calibrations have been detected.")
    return CalibrationSet(
        node=np.asarray(nodes, np.int32),
        lower=np.asarray(lowers, np.float64),
        lower_pm=np.asarray(lower_pms, np.float64),
        upper=np.asarray(uppers, np.float64),
        upper_pm=np.asarray(upper_pms, np.float64),
        names=tuple(names),
        paths=tuple(paths),
    )


def mean_root_height(cal: CalibrationSet) -> Optional[float]:
    """Mean of the root calibration interval, when the root is calibrated
    with a finite upper bound (``getMeanRootHeight``, Calibration.hs:321-339)."""
    root_idx = [i for i in range(cal.n) if cal.node[i] == 0]
    if len(root_idx) != 1:
        return None
    i = root_idx[0]
    if not np.isfinite(cal.upper[i]):
        return None
    lo = cal.lower[i]
    return float((lo + cal.upper[i]) / 2.0)


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------


def _is_ancestor(topo: FlatTopology, a: int, b: int) -> bool:
    """True when a is a (proper) ancestor of b."""
    return a < b < int(topo.subtree_end[a])


def load_constraints_csv(
    path_or_text: str,
    tree: Node,
    topo: FlatTopology,
    *,
    ignore_problematic: bool = False,
    log=print,
    is_text: bool = False,
) -> ConstraintSet:
    text = path_or_text if is_text else open(path_or_text).read()
    rows = list(csv.reader(_io.StringIO(text)))[1:]
    recs = []
    for row in rows:
        if not row or all(not c.strip() for c in row):
            continue
        name, ya, yb, oa, ob, pm = [c.strip() for c in row[:6]]
        y = _mrca_index(topo, tree, [ya, yb], f"constraint {name} (young)")
        o = _mrca_index(topo, tree, [oa, ob], f"constraint {name} (old)")
        recs.append((name, y, o, float(pm)))
    if not recs:
        raise SpecError("loadConstraints: No constraints found.")

    keep: List[Tuple[str, int, int, float]] = []
    for name, y, o, pm in recs:
        if y == o:
            raise SpecError(f"Constraint {name}: Young and old nodes are equal.")
        if _is_ancestor(topo, y, o):
            raise SpecError(
                f"Constraint {name}: Young node is an ancestor of the old node."
            )
        if _is_ancestor(topo, o, y):
            # Redundant: the old node is an ancestor of the young node, the
            # order is enforced by ultrametricity (Constraint.hs:230-232).
            log(f"Constraint {name} is redundant (old is an ancestor of young); dropped.")
            continue
        if not (0 < pm < 1):
            raise SpecError(f"Constraint {name}: Probability mass {pm} out of range.")
        keep.append((name, y, o, pm))

    # Conflicts: two constraints enforcing opposite orders on the same pair
    # (Constraint.hs:239-241); duplicates are dropped.
    final: List[Tuple[str, int, int, float]] = []
    seen_pairs = {}
    for name, y, o, pm in keep:
        if (o, y) in seen_pairs:
            msg = f"Conflicting constraints on nodes {y} and {o}."
            if ignore_problematic:
                log("WARNING: " + msg + " Dropping " + name + ".")
                continue
            raise SpecError(msg)
        if (y, o) in seen_pairs:
            log(f"Constraint {name} is a duplicate; dropped.")
            continue
        seen_pairs[(y, o)] = name
        final.append((name, y, o, pm))
    if not final:
        raise SpecError("loadConstraints: All constraints were dropped.")
    return ConstraintSet(
        young=np.asarray([r[1] for r in final], np.int32),
        old=np.asarray([r[2] for r in final], np.int32),
        pm=np.asarray([r[3] for r in final], np.float64),
        names=tuple(r[0] for r in final),
    )


# ---------------------------------------------------------------------------
# Braces
# ---------------------------------------------------------------------------


def load_braces_json(
    path_or_text: str,
    tree: Node,
    topo: FlatTopology,
    *,
    log=print,
    is_text: bool = False,
) -> BraceSet:
    text = path_or_text if is_text else open(path_or_text).read()
    data = json.loads(text)
    names, node_lists, sds = [], [], []
    for rec in data:
        name = rec["braceDataName"]
        sd = float(rec["braceDataStandardDeviation"])
        if sd <= 0:
            raise SpecError(f"Brace {name}: Standard deviation is zero or negative.")
        pairs = rec["braceDataNodes"]
        if len(pairs) < 2:
            raise SpecError(f"Brace {name}: Fewer than two nodes.")
        idxs = []
        for pair in pairs:
            idxs.append(_mrca_index(topo, tree, pair, f"brace {name}"))
        if len(set(idxs)) != len(idxs):
            raise SpecError(f"Brace {name}: Duplicate nodes.")
        for a in idxs:
            if a == 0:
                raise SpecError(f"Brace {name}: Braced root node.")
            for b in idxs:
                if a != b and _is_ancestor(topo, a, b):
                    raise SpecError(f"Brace {name}: Node {a} is an ancestor of node {b}.")
        names.append(name)
        node_lists.append(idxs)
        sds.append(sd)
    if not names:
        raise SpecError("loadBraces: No braces found.")
    width = max(len(l) for l in node_lists)
    node = np.full((len(names), width), -1, np.int32)
    for i, l in enumerate(node_lists):
        node[i, : len(l)] = l
    log(f"Loaded {len(names)} braces.")
    return BraceSet(node=node, sd=np.asarray(sds, np.float64), names=tuple(names))
