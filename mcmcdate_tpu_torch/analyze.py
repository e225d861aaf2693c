"""Post-processing of monitor files.

Python equivalents of the reference's shell/Haskell workflow scripts
(scripts/analyze, trace-thin, trees-monitor-summary[-ultrametric],
trees-monitor-to-nexus, trees-midpoint-root, tree-identify — SURVEY.md §2.3):

- :func:`thin` — keep every k-th monitor row (scripts/trace-thin).
- :func:`summarize_trees` — per-branch posterior mean / quantile trees from
  a tree monitor file (scripts/trees-monitor-summary).
- :func:`to_nexus` — convert a tree monitor to a Nexus trees block
  (scripts/trees-monitor-to-nexus).
- :func:`midpoint_root` — midpoint rooting (scripts/trees-midpoint-root).
- :func:`identify` — label nodes by index (scripts/tree-identify).

Host copy of ``mcmcdate_tpu/analyze.py`` over the port's copies of
``tree/``, ``engine.checkpoint.load_trace`` and ``engine.diagnostics.rhat``:
the files it writes are byte-identical to the JAX package's.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from .tree.flat import FlatTopology
from .tree.rose import Node, assign_indices, parse_newick, write_newick


def read_tree_monitor(path: str) -> Tuple[List[int], List[Node]]:
    """Read a ``<an>.{timetree,ratetree}.monitor`` file (Iteration\\tNewick)."""
    its, trees = [], []
    with open(path) as fh:
        header = fh.readline()
        for line in fh:
            line = line.strip()
            if not line:
                continue
            it, nwk = line.split("\t", 1)
            its.append(int(it))
            trees.append(parse_newick(nwk))
    return its, trees


def thin(path: str, out_path: str, k: int) -> int:
    """Keep the header and every k-th row of a monitor file."""
    n = 0
    with open(path) as fin, open(out_path, "w") as fout:
        fout.write(fin.readline())
        for i, line in enumerate(fin):
            if i % k == 0:
                fout.write(line)
                n += 1
    return n


def summarize_trees(
    path: str,
    *,
    burn_in_fraction: float = 0.25,
    quantiles: Sequence[float] = (0.025, 0.5, 0.975),
) -> dict:
    """Posterior per-branch summary of a tree monitor.

    Returns ``{"mean": newick, "q<q>": newick, ...}``; all trees must share
    one topology (guaranteed for monitor output).  Mirrors
    scripts/trees-monitor-summary with its default 25% burn-in.
    """
    its, trees = read_tree_monitor(path)
    n_burn = int(len(trees) * burn_in_fraction)
    trees = trees[n_burn:]
    if not trees:
        raise ValueError("summarize_trees: no trees after burn-in")
    base = trees[0]
    lens = np.stack(
        [np.fromiter((n.length for n in t.preorder()), float) for t in trees]
    )

    def with_lengths(vals) -> str:
        t = base.copy()
        for nd, v in zip(t.preorder(), vals):
            nd.length = float(v)
        return write_newick(t)

    out = {"mean": with_lengths(lens.mean(axis=0)), "n": len(trees)}
    for q in quantiles:
        out[f"q{q}"] = with_lengths(np.quantile(lens, q, axis=0))
    return out


def _node_heights(trees: List[Node], topo: FlatTopology) -> np.ndarray:
    """Node heights (age above the leaves) per tree, [n_trees, n_nodes]."""
    out = []
    for t in trees:
        lens = np.fromiter((n.length for n in t.preorder()), float)
        h = np.zeros(topo.n)
        for i in range(1, topo.n):
            h[i] = h[topo.parent[i]] - lens[i]
        h -= h.min()
        out.append(h)
    return np.stack(out)


def summarize_trees_ultrametric(
    path: str,
    *,
    burn_in_fraction: float = 0.25,
    quantiles: Sequence[float] = (0.025, 0.5, 0.975),
    write_files: bool = True,
) -> dict:
    """Posterior summary trees that are ULTRAMETRIC by construction.

    The equivalent of scripts/trees-monitor-summary-ultrametric: summarize a
    time-tree monitor in NODE-HEIGHT space rather than branch space.  The
    mean-height tree equals the per-branch mean tree (mean of sums = sum of
    means — the reference script's own remark), but quantile trees built
    from per-branch quantiles are NOT ultrametric; per-node quantile heights
    are (parent > child pointwise in every sample implies the same for any
    quantile).  Outputs, mirroring the reference script's files for monitor
    path ``<stem>.monitor``:

    - ``<stem>.tree.mean``     Newick, mean node heights (ultrametric)
    - ``<stem>.tree.variance`` Newick, per-branch variances (reference parity)
    - ``<stem>.tree.q<q>``     Newick per quantile, node-height quantiles
    - ``<stem>.tree.combined`` Nexus, mean tree with
      ``[&index=..,posterior=1.0,age_95%_HPD={l,u}]`` node comments
    - ``<stem>.ages.summary``  per-node Index/Name/Mean/Variance/Min/Max/CI
    - ``<stem>.ages.full``     per-node list of sampled ages

    Returns the summary as a dict (newick strings + per-node table).
    """
    its, trees = read_tree_monitor(path)
    n_burn = int(len(trees) * burn_in_fraction)
    trees = trees[n_burn:]
    if not trees:
        raise ValueError("summarize_trees_ultrametric: no trees after burn-in")
    base = trees[0]
    topo = FlatTopology.from_tree(base)
    H = _node_heights(trees, topo)  # [n_trees, n_nodes]

    def tree_from_heights(h) -> str:
        t = base.copy()
        nodes = list(t.preorder())
        for i, nd in enumerate(nodes):
            nd.length = float(h[topo.parent[i]] - h[i]) if i else 0.0
        return write_newick(t)

    out = {"n": len(trees), "mean": tree_from_heights(H.mean(axis=0))}
    for q in quantiles:
        out[f"q{q}"] = tree_from_heights(np.quantile(H, q, axis=0))

    # Per-branch variance tree (what the reference's .tree.variance holds).
    lens = np.stack(
        [np.fromiter((n.length for n in t.preorder()), float) for t in trees]
    )
    var_t = base.copy()
    for nd, v in zip(var_t.preorder(), lens.var(axis=0, ddof=1)):
        nd.length = float(v)
    out["variance"] = write_newick(var_t)

    # Per-node age table (reference's .ages.summary: central 95% interval
    # from the sorted slice [floor(.025 n), floor(.025 n) + floor(.95 n))).
    n_s = H.shape[0]
    i_ci = int(np.floor(n_s * 0.025))
    n_ci = int(np.floor(n_s * 0.95))
    Hs = np.sort(H, axis=0)
    ci_l = Hs[i_ci]
    ci_u = Hs[min(i_ci + n_ci, n_s) - 1]
    table = {}
    for i in range(topo.n):
        name = topo.names[i] or str(i)
        table[name] = dict(
            index=i,
            mean=float(H[:, i].mean()),
            variance=float(H[:, i].var(ddof=1)) if n_s > 1 else 0.0,
            min=float(H[:, i].min()),
            max=float(H[:, i].max()),
            ci_lower=float(ci_l[i]),
            ci_upper=float(ci_u[i]),
        )
    out["ages"] = table

    # Combined tree: mean heights, node comments with index + age HPD.
    comb = parse_newick(out["mean"])
    for i, nd in enumerate(comb.preorder()):
        key = topo.names[i] or str(i)
        s = table[key]
        nd.comment = (
            f"[&index={i},posterior=1.0,"
            f"age_95%_HPD={{{s['ci_lower']:.6g},{s['ci_upper']:.6g}}}]"
        )
    out["combined"] = write_newick(comb)

    if write_files:
        stem = os.path.splitext(path)[0]
        with open(stem + ".tree.mean", "w") as fh:
            fh.write(out["mean"] + "\n")
        with open(stem + ".tree.variance", "w") as fh:
            fh.write(out["variance"] + "\n")
        for q in quantiles:
            with open(f"{stem}.tree.q{q}", "w") as fh:
                fh.write(out[f"q{q}"] + "\n")
        with open(stem + ".tree.combined", "w") as fh:
            fh.write("#NEXUS\n\nBegin trees;\n")
            fh.write(f"  tree Tree1 = {out['combined']}\n")
            fh.write("End;\n")
        with open(stem + ".ages.summary", "w") as fh:
            fh.write("Index\tName\tMean\tVariance\tMin\tMax\t"
                     "95CILower\t95CIUpper\n")
            for name, s in table.items():
                fh.write(
                    f"{s['index']}\t{name}\t{s['mean']:.6g}\t"
                    f"{s['variance']:.6g}\t{s['min']:.6g}\t{s['max']:.6g}\t"
                    f"{s['ci_lower']:.6g}\t{s['ci_upper']:.6g}\n"
                )
        with open(stem + ".ages.full", "w") as fh:
            fh.write("Index\tName\tAges\n")
            for name, s in table.items():
                ages = "\t".join(f"{a:.6g}" for a in H[:, s["index"]])
                fh.write(f"{s['index']}\t{name}\t{ages}\n")
    return out


def node_age_summary(path: str, *, burn_in_fraction: float = 0.25) -> dict:
    """Posterior node ages (heights) per internal node from a time-tree
    monitor; the basis for comparing against the reference's estimates."""
    its, trees = read_tree_monitor(path)
    n_burn = int(len(trees) * burn_in_fraction)
    trees = trees[n_burn:]
    topo = FlatTopology.from_tree(trees[0])
    ages = []
    for t in trees:
        lens = np.fromiter((n.length for n in t.preorder()), float)
        # node height = root height - depth; compute heights top-down
        h = np.zeros(topo.n)
        for i in range(1, topo.n):
            h[i] = h[topo.parent[i]] - lens[i]
        h -= h.min()
        ages.append(h)
    ages = np.stack(ages)
    out = {}
    for i in np.asarray(topo.inner_nodes):
        name = topo.names[i] or str(i)
        out[name] = dict(
            mean=float(ages[:, i].mean()),
            sd=float(ages[:, i].std()),
            q025=float(np.quantile(ages[:, i], 0.025)),
            q975=float(np.quantile(ages[:, i], 0.975)),
        )
    return out


def _split_modes(means: np.ndarray, within_sd: float):
    """Recursive widest-gap clustering of per-chain means.

    Split the sorted chain means at the widest gap while that gap exceeds
    2× the median within-chain sd and both sides keep ≥ 2 chains (the
    goe_modes criterion); recurse into each side, so the ~4 joint deep
    backbone configurations of a GOE-scale run separate.  Returns a list
    of chain-index arrays, one per mode, ordered by mode mean.
    """
    def rec(idx):
        if len(idx) < 4:
            return [idx]
        order = idx[np.argsort(means[idx])]
        gaps = np.diff(means[order])
        i = int(np.argmax(gaps))
        if gaps[i] < 2.0 * within_sd or i == 0 or i == len(order) - 2:
            if gaps[i] < 2.0 * within_sd or not 0 < i + 1 < len(order):
                return [idx]
        lo, hi = order[: i + 1], order[i + 1:]
        if len(lo) < 2 or len(hi) < 2:
            return [idx]
        return rec(lo) + rec(hi)

    return rec(np.arange(len(means)))


def mode_report(
    analysis_name: str,
    out_dir: str = ".",
    *,
    rhat_threshold: float = 1.1,
    burn_in_fraction: float = 0.25,
    write_files: bool = True,
) -> dict:
    """Per-MODE posterior summaries for multimodal monitored node ages.

    The reference runs ONE chain (tutorial/main/tutorial.org:442): a
    single-chain sampler sits inside one mode of a multimodal posterior,
    produces a clean-looking trace, and silently reports whichever mode it
    entered.  This engine runs hundreds of chains and keeps their full
    node-age histories in the checkpoint trace sidecar; when a monitored
    age's cross-chain R-hat exceeds ``rhat_threshold``, reporting the
    blended mean would describe NEITHER mode, so this emits per-mode rows
    instead: chains per mode, occupancy, per-mode mean/sd/95% interval,
    and the mode's average log posterior (mass comparison).

    Modes are per-chain-mean clusters split recursively at gaps wider
    than 2× the median within-chain sd (:func:`_split_modes` — the
    measured GOE deep-backbone clusters sit ~7 within-sds apart, PERF.md
    "GOE deep-backbone bimodality").  Writes ``<an>.ages.modes`` (TSV)
    when any monitored quantity fails the threshold; returns
    ``{name: {rhat, within_sd, modes: [...]}}`` for the failing ones.
    """
    from .engine.checkpoint import load_trace
    from .engine.diagnostics import rhat

    tr = load_trace(analysis_name, in_dir=out_dir)
    if tr is None:
        return {}
    lp = tr.get("lp_post")
    report = {}
    for name, arr in tr.items():
        if not name.startswith("age["):
            continue
        a = np.asarray(arr, np.float64)
        a = a[int(a.shape[0] * burn_in_fraction):]
        if a.shape[0] < 8 or a.std() == 0.0:
            continue
        r = rhat(a)
        if not (r > rhat_threshold):
            continue
        means = a.mean(axis=0)
        within = float(np.median(a.std(axis=0)))
        groups = _split_modes(means, within)
        modes = []
        for idx in sorted(groups, key=lambda g: means[g].mean()):
            draws = a[:, idx].ravel()
            row = dict(
                chains=int(len(idx)),
                occupancy=float(len(idx) / a.shape[1]),
                mean=float(draws.mean()),
                sd=float(draws.std()),
                q025=float(np.quantile(draws, 0.025)),
                q975=float(np.quantile(draws, 0.975)),
            )
            if lp is not None:
                row["mean_lp"] = float(
                    np.asarray(lp, np.float64)[
                        int(lp.shape[0] * burn_in_fraction):, idx
                    ].mean()
                )
            modes.append(row)
        report[name] = dict(rhat=float(r), within_sd=within, modes=modes)

    if write_files and report:
        path = os.path.join(out_dir, f"{analysis_name}.ages.modes")
        with open(path, "w") as fh:
            fh.write("Parameter\tRhat\tMode\tChains\tOccupancy\tMean\tSD\t"
                     "Q025\tQ975\tMeanLP\n")
            for name, rep in report.items():
                for j, m in enumerate(rep["modes"]):
                    fh.write(
                        f"{name}\t{rep['rhat']:.4f}\t{j}\t{m['chains']}\t"
                        f"{m['occupancy']:.4f}\t{m['mean']:.6g}\t"
                        f"{m['sd']:.6g}\t{m['q025']:.6g}\t{m['q975']:.6g}\t"
                        f"{m.get('mean_lp', float('nan')):.6g}\n"
                    )
    return report


def to_nexus(path: str, out_path: str) -> int:
    """Convert a tree monitor file to a Nexus trees block."""
    its, trees = read_tree_monitor(path)
    taxa = trees[0].leaf_names()
    with open(out_path, "w") as fh:
        fh.write("#NEXUS\n\nBegin taxa;\n")
        fh.write(f"  Dimensions ntax={len(taxa)};\n  Taxlabels\n")
        for t in taxa:
            fh.write(f"    {t}\n")
        fh.write("  ;\nEnd;\n\nBegin trees;\n")
        for it, t in zip(its, trees):
            fh.write(f"  tree STATE_{it} = {write_newick(t)}\n")
        fh.write("End;\n")
    return len(trees)


def densitree_prep(path: str, out_path: str, thin_by: int = 5) -> int:
    """Produce the densitree-viewer input for a tree monitor.

    Mirrors scripts/trees-monitor-densitree: thin the monitor by ``thin_by``
    (trace-thin), convert to a Nexus trees block (trees-monitor-to-nexus),
    and return the number of trees written.  The actual rendering is done by
    an external densitree viewer on the produced ``.nex`` file, exactly as
    in the reference workflow.
    """
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".monitor", delete=False,
                                     dir=os.path.dirname(os.path.abspath(out_path))) as tf:
        tmp = tf.name
    try:
        thin(path, tmp, thin_by)
        return to_nexus(tmp, out_path)
    finally:
        os.unlink(tmp)


def midpoint_root(tree: Node) -> Node:
    """Root at the midpoint of the longest leaf-to-leaf path.

    True midpoint rooting (scripts/trees-midpoint-root): un-root, find the
    tree diameter (the longest leaf-to-leaf path), locate the edge on that
    path containing the halfway point, and create the new bifurcating root
    ON that edge, splitting its length so both new root branches reach their
    deepest leaves at equal distance.
    """
    from .tree.rose import _reverse_up, _unroot

    u = _unroot(tree.copy())
    parent_map = {}
    for node in u.preorder():
        for c in node.children:
            parent_map[id(c)] = node

    # Distances from the (arbitrary) unrooted-representation root.
    depth = {id(u): 0.0}
    for node in u.preorder():
        for c in node.children:
            depth[id(c)] = depth[id(node)] + c.length

    def ancestors(n: Node):
        out = [n]
        while id(n) in parent_map:
            n = parent_map[id(n)]
            out.append(n)
        return out

    leaves = u.leaves()
    best = (-1.0, None, None, None)
    anc = {id(a): ancestors(a) for a in leaves}
    for i, a in enumerate(leaves):
        seen = {id(x) for x in anc[id(a)]}
        for b in leaves[i + 1:]:
            m = next(x for x in anc[id(b)] if id(x) in seen)
            dist = depth[id(a)] + depth[id(b)] - 2 * depth[id(m)]
            if dist > best[0]:
                best = (dist, a, b, m)
    dist, a, b, m = best
    if dist <= 0:
        return tree.copy()
    half = dist / 2.0

    # Walk a -> mrca -> b; find the edge containing the halfway point.  Each
    # edge is identified by its LOWER node (the child in the rooted
    # representation); record the midpoint's offset from that child end.
    up_path = []  # edges from a up to mrca (child nodes)
    x = a
    while x is not m:
        up_path.append(x)
        x = parent_map[id(x)]
    down_path = []  # edges from mrca down to b, in walk order
    x = b
    while x is not m:
        down_path.append(x)
        x = parent_map[id(x)]
    down_path.reverse()

    s = 0.0
    edge_child, off_child = None, 0.0
    for c in up_path:  # walking child -> parent
        if s + c.length >= half:
            edge_child, off_child = c, half - s
            break
        s += c.length
    if edge_child is None:
        for c in down_path:  # walking parent -> child
            if s + c.length >= half:
                edge_child, off_child = c, c.length - (half - s)
                break
            s += c.length
    assert edge_child is not None

    # Re-root on that edge (same surgery as rose.outgroup).
    total = edge_child.length
    p = parent_map[id(edge_child)]
    p.children = [c for c in p.children if c is not edge_child]
    rest = _reverse_up(p, parent_map, u)
    edge_child.length = off_child
    rest.length = total - off_child
    return Node(0.0, "", [edge_child, rest])


def identify(tree: Node) -> Node:
    """Label nodes by pre-order index (scripts/tree-identify)."""
    return assign_indices(tree)
