"""Host-side rose tree with Newick I/O and phylogenetic tree operations.

This module replaces the capabilities of the reference's external
``elynx-tree`` Haskell package (see the reference's app/Main.hs:42-43,
lib/Mcmc/Tree/Import.hs:29): Newick parse/print, re-rooting by outgroup,
bipartition, topology equality, MRCA paths, index assignment, ultrametric
utilities.  It is pure-Python/NumPy host code; the sampling hot path never
touches it — trees are compiled to flat integer arrays (see
:mod:`.flat`) before anything runs on TPU.
"""

from __future__ import annotations

import gzip
import io
import math
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple


import sys as _sys

# The recursive-descent parser and tree walkers recurse once per nesting
# level; a 1k-taxa caterpillar tree nests ~1000 deep, beyond CPython's
# default limit.  Python frames live on the heap, so a high limit is safe.
_sys.setrecursionlimit(max(_sys.getrecursionlimit(), 100_000))


class NewickError(ValueError):
    pass


@dataclass
class Node:
    """A rooted (rose) tree node.

    ``length`` is the length of the branch leading to this node (the stem for
    the root).  ``name`` may be empty for unnamed internal nodes.
    """

    length: float = 0.0
    name: str = ""
    children: List["Node"] = field(default_factory=list)

    # -- basic structure -------------------------------------------------

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def preorder(self) -> Iterator["Node"]:
        stack = [self]
        while stack:
            n = stack.pop()
            yield n
            # Reverse so children are visited left-to-right.
            stack.extend(reversed(n.children))

    def postorder(self) -> Iterator["Node"]:
        out = []
        stack = [self]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children)
        return reversed(out)

    def leaves(self) -> List["Node"]:
        return [n for n in self.preorder() if n.is_leaf]

    def leaf_names(self) -> List[str]:
        return [n.name for n in self.leaves()]

    def n_nodes(self) -> int:
        return sum(1 for _ in self.preorder())

    def n_inner(self) -> int:
        """Number of internal (non-leaf) nodes."""
        return sum(1 for n in self.preorder() if not n.is_leaf)

    def depth(self) -> int:
        """Depth as in elynx-tree: leaves have depth 1."""
        if self.is_leaf:
            return 1
        return 1 + max(c.depth() for c in self.children)

    def copy(self) -> "Node":
        return Node(self.length, self.name, [c.copy() for c in self.children])

    # -- heights ---------------------------------------------------------

    def root_height(self) -> float:
        """Distance from this node to its deepest leaf."""
        if self.is_leaf:
            return 0.0
        return max(c.length + c.root_height() for c in self.children)

    def is_ultrametric(self, rel_tol: float = 1e-10) -> bool:
        h = self.root_height()
        tol = max(h, 1.0) * rel_tol

        def go(n: Node, acc: float) -> bool:
            if n.is_leaf:
                return abs(acc - h) <= tol
            return all(go(c, acc + c.length) for c in n.children)

        return all(go(c, c.length) for c in self.children)

    # -- equality --------------------------------------------------------

    def topology_key_ordered(self):
        """Hashable topology key keeping sub-tree order (leaf names only)."""
        if self.is_leaf:
            return self.name
        return tuple(c.topology_key_ordered() for c in self.children)

    def topology_key_unordered(self):
        """Hashable topology key ignoring sub-tree order."""
        if self.is_leaf:
            return self.name
        return tuple(sorted((c.topology_key_unordered() for c in self.children), key=repr))


# ---------------------------------------------------------------------------
# Newick parsing / printing
# ---------------------------------------------------------------------------


def _strip_comments(s: str) -> str:
    """Remove square-bracket comments outside of quoted labels."""
    out = []
    depth = 0
    in_quote = False
    for ch in s:
        if in_quote:
            out.append(ch)
            if ch == "'":
                in_quote = False
        elif depth > 0:
            if ch == "]":
                depth -= 1
            elif ch == "[":
                depth += 1
        else:
            if ch == "[":
                depth += 1
            elif ch == "'":
                in_quote = True
                out.append(ch)
            else:
                out.append(ch)
    if depth != 0:
        raise NewickError("Unbalanced square-bracket comment.")
    return "".join(out)


def parse_newick(s: str) -> Node:
    """Parse a single Newick tree string.

    Supports quoted labels (``'...'``), internal node labels, and branch
    lengths.  Square-bracket comments are stripped.
    """
    s = _strip_comments(s.strip())
    if not s:
        raise NewickError("Empty Newick string.")
    pos = 0
    n = len(s)

    def error(msg: str):
        raise NewickError(f"{msg} (at position {pos}: ...{s[max(0, pos - 10):pos + 10]!r}...)")

    def skip_ws():
        nonlocal pos
        while pos < n and s[pos] in " \t\n\r":
            pos += 1

    def parse_label() -> str:
        nonlocal pos
        skip_ws()
        if pos < n and s[pos] == "'":
            pos += 1
            start = pos
            buf = []
            while pos < n:
                if s[pos] == "'":
                    if pos + 1 < n and s[pos + 1] == "'":  # escaped quote
                        buf.append(s[start:pos] + "'")
                        pos += 2
                        start = pos
                        continue
                    buf.append(s[start:pos])
                    pos += 1
                    return "".join(buf)
                pos += 1
            error("Unterminated quoted label")
        start = pos
        while pos < n and s[pos] not in "(),:;[]":
            pos += 1
        return s[start:pos].strip()

    def parse_length() -> float:
        nonlocal pos
        skip_ws()
        if pos < n and s[pos] == ":":
            pos += 1
            start = pos
            while pos < n and s[pos] not in "(),;[]":
                pos += 1
            try:
                return float(s[start:pos])
            except ValueError:
                error(f"Invalid branch length {s[start:pos]!r}")
        return 0.0

    def parse_node() -> Node:
        nonlocal pos
        node = Node()
        skip_ws()
        if pos < n and s[pos] == "(":
            pos += 1
            while True:
                node.children.append(parse_node())
                skip_ws()
                if pos >= n:
                    error("Unexpected end of input inside group")
                if s[pos] == ",":
                    pos += 1
                    continue
                if s[pos] == ")":
                    pos += 1
                    break
                error(f"Unexpected character {s[pos]!r}")
        node.name = parse_label()
        node.length = parse_length()
        return node

    root = parse_node()
    while pos < n and s[pos] in "; \t\n\r":
        pos += 1
    if pos != n:
        raise NewickError(f"Trailing characters after tree: {s[pos:]!r}")
    return root


_UNQUOTED_SAFE = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-+|/")


def _format_label(name: str) -> str:
    if name and all(c in _UNQUOTED_SAFE for c in name):
        return name
    if not name:
        return ""
    return "'" + name.replace("'", "''") + "'"


def _format_length(x: float) -> str:
    # Round-trippable, compact.
    return repr(float(x))


def write_newick(t: Node, with_lengths: bool = True) -> str:
    parts: List[str] = []

    def go(n: Node):
        if n.children:
            parts.append("(")
            for i, c in enumerate(n.children):
                if i:
                    parts.append(",")
                go(c)
            parts.append(")")
        parts.append(_format_label(n.name))
        # Raw bracket comment (e.g. FigTree/BEAST "[&...]" annotations) —
        # emitted verbatim after the label, never quoted.
        comment = getattr(n, "comment", "")
        if comment:
            parts.append(comment)
        if with_lengths:
            parts.append(":" + _format_length(n.length))

    go(t)
    parts.append(";")
    return "".join(parts)


def _open_maybe_gz(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_one_newick(path: str) -> Node:
    """Read a single Newick tree from a (possibly gzipped) file."""
    with _open_maybe_gz(path) as fh:
        return parse_newick(fh.read())


def read_many_newick(path: str) -> List[Node]:
    """Read a list of Newick trees (one per line) from a (possibly gzipped) file.

    Replaces the reference's ``someTrees Standard`` with transparent gunzip
    (lib/Mcmc/Tree/Import.hs:43-49).
    """
    trees = []
    with _open_maybe_gz(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                trees.append(parse_newick(line))
    return trees


# ---------------------------------------------------------------------------
# Tree operations
# ---------------------------------------------------------------------------


def duplicate_leaves(t: Node) -> bool:
    names = t.leaf_names()
    return len(names) != len(set(names))


def bipartition(t: Node) -> Tuple[frozenset, frozenset]:
    """Leaf-set bipartition induced by a bifurcating root (elynx `bipartition`)."""
    if len(t.children) != 2:
        raise ValueError("bipartition: Root node is not bifurcating.")
    l, r = t.children
    return frozenset(l.leaf_names()), frozenset(r.leaf_names())


def _unroot(t: Node) -> Node:
    """Suppress a bifurcating root, merging the two root branches.

    Returns a tree rooted at the first multifurcating/leaf-bearing node; the
    merged branch length is assigned to the former second child.
    """
    if len(t.children) != 2:
        # Already multifurcating — treat as unrooted.
        return t
    l, r = t.children
    merged = l.length + r.length
    if not l.is_leaf:
        new_root = Node(0.0, l.name, [c for c in l.children])
        r2 = r.copy()
        r2.length = merged
        new_root.children.append(r2)
        return new_root
    if not r.is_leaf:
        new_root = Node(0.0, r.name, [c for c in r.children])
        l2 = l.copy()
        l2.length = merged
        new_root.children.append(l2)
        return new_root
    raise ValueError("unroot: Cannot unroot a two-leaf (cherry) tree.")


def outgroup(t: Node, og: frozenset) -> Node:
    """Re-root ``t`` at the edge separating leaf set ``og`` from the rest.

    Mirrors elynx-tree ``outgroup`` as used at app/Main.hs:179-180.  The edge
    found is split in half to create the new bifurcating root; the outgroup
    clade becomes the first child.
    """
    all_leaves = frozenset(t.leaf_names())
    if not og or not og < all_leaves:
        if og == all_leaves:
            raise ValueError("outgroup: Outgroup contains all leaves.")
        missing = og - all_leaves
        if missing:
            raise ValueError(f"outgroup: Leaves not found in tree: {sorted(missing)}.")
        raise ValueError("outgroup: Empty outgroup.")
    ingroup = all_leaves - og

    u = _unroot(t.copy())

    # Find, in the unrooted tree, the edge (parent->child) whose subtree leaf
    # set is `og` or `ingroup`.  If `og`'s edge is found, root there with the
    # og side first; with `ingroup`'s edge, root there with the og side first
    # as well (the og side is then the complement).
    parent_map = {}
    for node in u.preorder():
        for c in node.children:
            parent_map[id(c)] = node

    target_child = None
    og_is_subtree = True
    for node in u.preorder():
        if node is u:
            continue
        ls = frozenset(node.leaf_names())
        if ls == og:
            target_child = node
            og_is_subtree = True
            break
        if ls == ingroup:
            target_child = node
            og_is_subtree = False
            break
    if target_child is None:
        raise ValueError("outgroup: Bipartition not found; the outgroup is not monophyletic.")

    # Re-root at the edge above target_child: walk from target_child up to the
    # root, reversing edges.
    half = target_child.length / 2.0

    def detach(child: Node):
        p = parent_map[id(child)]
        p.children = [c for c in p.children if c is not child]
        return p

    # Build the "rest" side: reverse the path from parent(target) to old root.
    p = detach(target_child)
    rest = _reverse_up(p, parent_map, u)
    side_a = target_child
    side_a.length = half
    rest.length = half
    if og_is_subtree:
        children = [side_a, rest]
    else:
        children = [rest, side_a]
    return Node(0.0, "", children)


def _reverse_up(node: Node, parent_map, root: Node) -> Node:
    """Reverse edges from `node` up to `root`, returning `node` as a subtree
    that now contains everything that was above it."""
    if node is root:
        return node
    p = parent_map[id(node)]
    p.children = [c for c in p.children if c is not node]
    upper = _reverse_up(p, parent_map, root)
    upper.length = node.length
    node.children.append(upper)
    return node


def mrca_path(t: Node, names: Sequence[str]) -> List[int]:
    """Path (list of child indices) from the root to the MRCA of ``names``.

    Mirrors elynx ``getPathToMrca`` (used at
    lib/Mcmc/Tree/Prior/Node/Calibration.hs:170).
    """
    want = set(names)
    if not want:
        raise ValueError("mrca_path: No leaf names given.")
    missing = want - set(t.leaf_names())
    if missing:
        raise ValueError(f"mrca_path: Leaves not found: {sorted(missing)}.")

    path: List[int] = []
    node = t
    while True:
        if node.is_leaf:
            return path
        nxt = None
        for i, c in enumerate(node.children):
            ls = set(c.leaf_names())
            if want <= ls:
                nxt = (i, c)
                break
            if want & ls:
                # Leaves split across children: this is the MRCA.
                return path
        if nxt is None:
            return path
        path.append(nxt[0])
        node = nxt[1]


def node_at_path(t: Node, path: Sequence[int]) -> Node:
    node = t
    for i in path:
        node = node.children[i]
    return node


def assign_indices(t: Node) -> Node:
    """Label nodes with running pre-order indices, keeping alphabetic names.

    Mirrors ``identify``/``assignIndices`` (app/Tools.hs:74-81,
    app/Main.hs:300): a node keeps its name iff the name is non-empty and not
    a pure integer; otherwise it is replaced by its pre-order index.
    """
    t = t.copy()
    for i, node in enumerate(t.preorder()):
        nm = node.name
        if nm == "" or _is_int(nm):
            node.name = str(i)
    return t


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def make_ultrametric(t: Node) -> Node:
    """Elongate terminal branches so all leaves are equally distant from the
    root (elynx ``makeUltrametric``, used at app/Definitions.hs:123)."""
    t = t.copy()
    h = t.root_height()

    def go(n: Node, acc: float):
        if n.is_leaf:
            n.length += h - acc
            return
        for c in n.children:
            go(c, acc + c.length)

    for c in t.children:
        go(c, c.length)
    return t


def normalize_height(t: Node) -> Node:
    """Scale all branch lengths so the root height becomes 1.0."""
    t = t.copy()
    h = t.root_height()
    if h <= 0:
        raise ValueError("normalize_height: Root height is zero or negative.")
    for n in t.preorder():
        n.length /= h
    return t


def tree_from_arrays(parents, names, lengths) -> Node:
    """Rebuild a rose tree from pre-order parent indices, names, lengths."""
    nodes = [Node(float(l), str(n), []) for n, l in zip(names, lengths)]
    for i, p in enumerate(parents):
        if p >= 0:
            nodes[p].children.append(nodes[i])
    return nodes[0]


def node_heights(t: Node) -> List[float]:
    """Heights of all nodes in pre-order, assuming an ultrametric tree
    (leaves at height 0).  Heights are computed top-down from the root height
    so they are exactly consistent with parent heights."""
    h0 = t.root_height()
    out: List[float] = []

    def go(n: Node, h: float):
        out.append(h)
        for c in n.children:
            go(c, h - c.length)

    go(t, h0)
    return out
