"""Reordering strategies: permutations that make unstructured matrices
FD-like, so `auto_format` / `plan.compile` can re-decide the format.

Counterpart of `repro.reorder.strategies`, giving the reference's
permutations byte for byte (same `strategy`, `params` and `stats`):

  rcm          reverse Cuthill-McKee bandwidth reduction
  degree_sort  rows ordered by nnz (stable)
  cache_block  columns packed by the row block that first touches them
  chain        left-to-right composition of strategies

RCM keeps the reference's algorithm -- components seeded in increasing
degree order, each traversed breadth-first from a George-Liu
pseudo-peripheral node, neighbours visited in (degree, id) order, the
whole order reversed -- but runs its breadth-first searches a level at a
time: the next level is the frontier's neighbour lists concatenated in
frontier order, minus what was visited before the level, each node kept
at its first occurrence.  That is exactly the order the reference's
node-at-a-time queue appends, with one numpy pass per level instead of
one Python step per node.  A component of `BFS_MIN_NODES` nodes or more
(a long band has hundreds of thousands of levels) is searched instead by
scipy's compiled breadth-first search, which appends in that same queue
order over the sorted adjacency; its levels are read off the
predecessors.  The large sorts run on the matrix's device
(`device.stable_argsort`): a stable sort's result is unique, so it is
the same wherever it runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from repro_torch.core.formats import CSR
from repro_torch.device import stable_argsort, to_numpy, unique

from .types import Reordering, identity_reordering

Strategy = Callable[[CSR], Reordering]


def _coords(csr: CSR):
    """(rows, cols) int64 of every stored nonzero, CSR order."""
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths())
    return rows, to_numpy(csr.indices).astype(np.int64)


# ---------------------------------------------------------------------------
# Reverse Cuthill-McKee
# ---------------------------------------------------------------------------

def _symmetric_adjacency(csr: CSR):
    """(adj_ptr, adj, deg) of the symmetrized pattern A | A^T, self-loops
    dropped, each node's neighbours sorted by (degree, id)."""
    rows, cols = _coords(csr)
    n = max(csr.n_rows, csr.n_cols)
    u = np.concatenate([rows, cols])
    v = np.concatenate([cols, rows])
    keep = u != v
    keys = unique(u[keep] * n + v[keep], csr.device)
    u, v = keys // n, keys % n
    deg = np.bincount(u, minlength=n)
    # rank of each node in (degree, id) order; one sort of u * n + rank[v]
    # is the reference's lexsort((v, deg[v], u))
    rank = np.empty(n, dtype=np.int64)
    rank[stable_argsort(deg, csr.device)] = np.arange(n, dtype=np.int64)
    v = v[stable_argsort(u * n + rank[v], csr.device)]
    adj_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=adj_ptr[1:])
    return adj_ptr, v, deg


def _neighbours(frontier: np.ndarray, adj_ptr, adj) -> np.ndarray:
    """The frontier's neighbour lists, concatenated in frontier order."""
    if frontier.size == 1:
        f = frontier[0]
        return adj[adj_ptr[f]:adj_ptr[f + 1]]
    starts = adj_ptr[frontier]
    lens = adj_ptr[frontier + 1] - starts
    ends = lens.cumsum()
    if ends.size == 0 or ends[-1] == 0:
        return adj[:0]
    return adj[np.arange(ends[-1]) + (starts - ends + lens).repeat(lens)]


def _last_level(start: int, adj_ptr, adj, seen: np.ndarray,
                mark: np.ndarray):
    """Breadth-first levels from `start`: (eccentricity, the node set of
    the last level).  `seen` is all False on entry and is left so;
    `mark` is scratch."""
    seen[start] = True
    frontier = np.array([start], dtype=np.int64)
    touched = [frontier]
    ecc = 0
    while True:
        nbrs = _neighbours(frontier, adj_ptr, adj)
        nbrs = nbrs[~seen[nbrs]]
        if nbrs.size == 0:
            break
        # one occurrence of each node survives, whichever write won
        at = np.arange(nbrs.size)
        mark[nbrs] = at
        nbrs = nbrs[mark[nbrs] == at]
        ecc += 1
        seen[nbrs] = True
        touched.append(nbrs)
        frontier = nbrs
    seen[np.concatenate(touched)] = False
    return ecc, frontier


def _pseudo_peripheral(start: int, adj_ptr, adj, deg, seen, mark) -> int:
    """George-Liu: repeat the search from the last level's min-degree
    node (the lowest id among ties) until the eccentricity stops
    growing."""
    node = start
    last_ecc = -1
    for _ in range(8):
        ecc, frontier = _last_level(node, adj_ptr, adj, seen, mark)
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        d = deg[frontier]
        node = int(frontier[d == d.min()].min())
    return node


#: components this large are searched by scipy's breadth-first search (a
#: call costs O(nodes of the matrix)); smaller ones a level at a time
BFS_MIN_NODES = 1024


def _graph(adj_ptr, adj, n: int):
    """The adjacency as scipy's csgraph input, neighbours in their
    sorted order (float64 weights and int32 indices: no conversion per
    search)."""
    from scipy.sparse import csr_matrix
    return csr_matrix((np.ones(adj.size), adj.astype(np.int32),
                       adj_ptr.astype(np.int32)), shape=(n, n))


def _bfs(graph, start: int, levels: bool = False):
    """scipy's breadth-first order from `start`: the queue order over
    each node's sorted neighbours.  With `levels`: (order, depth of each
    node of the order), depths by pointer jumping on the parents'
    positions in the order."""
    from scipy.sparse.csgraph import breadth_first_order
    if not levels:
        return breadth_first_order(graph, start, directed=True,
                                   return_predecessors=False)
    order, pred = breadth_first_order(graph, start, directed=True,
                                      return_predecessors=True)
    where = np.empty(graph.shape[0], dtype=np.int64)
    where[order] = np.arange(order.size)
    up = np.zeros(order.size, dtype=np.int64)
    up[1:] = where[pred[order[1:]]]
    depth = np.ones(order.size, dtype=np.int64)
    depth[0] = 0
    while up.any():
        depth += depth[up]
        up = up[up]
    return order, depth


def _pseudo_peripheral_bfs(start: int, graph, deg) -> int:
    """`_pseudo_peripheral` through `_bfs`."""
    node = start
    last_ecc = -1
    for _ in range(8):
        order, depth = _bfs(graph, node, levels=True)
        ecc = int(depth[-1])            # the order runs level by level
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        frontier = order[depth == ecc]
        d = deg[frontier]
        node = int(frontier[d == d.min()].min())
    return node


def _first_unvisited(seeds: np.ndarray, visited: np.ndarray, i: int,
                     chunk: int = 4096) -> int:
    """Index of the first seed at or after `i` not yet visited
    (len(seeds) if none)."""
    while i < seeds.size:
        free = np.flatnonzero(~visited[seeds[i:i + chunk]])
        if free.size:
            return i + int(free[0])
        i += chunk
    return seeds.size


def rcm(csr: CSR) -> Reordering:
    """Reverse Cuthill-McKee: one symmetric permutation minimizing the
    bandwidth (rows and columns get the same order)."""
    n = max(csr.n_rows, csr.n_cols)
    adj_ptr, adj, deg = _symmetric_adjacency(csr)
    visited = np.zeros(n, dtype=bool)
    seen = np.zeros(n, dtype=bool)
    mark = np.zeros(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    # component seeds in increasing-degree order; the isolated nodes come
    # first and each is a component of its own
    seeds = stable_argsort(deg, csr.device)
    pos = int(np.count_nonzero(deg == 0))
    order[:pos] = seeds[:pos]
    visited[seeds[:pos]] = True
    i = pos
    graph = sizes = label = None
    if n - pos >= BFS_MIN_NODES:
        from scipy.sparse.csgraph import connected_components
        graph = _graph(adj_ptr, adj, n)
        label = connected_components(graph, directed=False)[1]
        sizes = np.bincount(label)
    while True:
        i = _first_unvisited(seeds, visited, i)
        if i == seeds.size:
            break
        if graph is not None and sizes[label[seeds[i]]] >= BFS_MIN_NODES:
            seed = _pseudo_peripheral_bfs(int(seeds[i]), graph, deg)
            comp = _bfs(graph, seed)    # the whole component, unvisited
            visited[comp] = True
            order[pos:pos + comp.size] = comp
            pos += comp.size
            continue
        seed = _pseudo_peripheral(int(seeds[i]), adj_ptr, adj, deg, seen,
                                  mark)
        if visited[seed]:
            i += 1
            continue
        visited[seed] = True
        order[pos] = seed
        pos += 1
        frontier = order[pos - 1:pos]
        while True:
            cand = _neighbours(frontier, adj_ptr, adj)
            cand = cand[~visited[cand]]
            if cand.size == 0:
                break
            # keep each node at its first occurrence, in order
            at = np.arange(cand.size)
            mark[cand] = cand.size
            np.minimum.at(mark, cand, at)
            nxt = cand[mark[cand] == at]
            visited[nxt] = True
            order[pos:pos + nxt.size] = nxt
            frontier = order[pos:pos + nxt.size]
            pos += nxt.size
    perm = order[::-1].copy()               # the reversal
    row_perm = perm if csr.n_rows == n else perm[perm < csr.n_rows]
    col_perm = perm if csr.n_cols == n else perm[perm < csr.n_cols]
    r = Reordering(row_perm=row_perm, col_perm=col_perm, strategy="rcm")
    return dataclasses.replace(
        r, stats={"bandwidth_before": _bandwidth(csr),
                  "bandwidth_after": _bandwidth(csr, r)})


def _bandwidth(csr: CSR, reordering: Reordering | None = None) -> int:
    """max |col - row|, optionally under a reordering (no permuted CSR is
    built)."""
    if csr.nnz == 0:
        return 0
    rows, cols = _coords(csr)
    if reordering is not None:
        rows = reordering.inv_row_perm[rows]
        cols = reordering.inv_col_perm[cols]
    return int(np.abs(cols - rows).max())


# ---------------------------------------------------------------------------
# Degree / nnz row sorting
# ---------------------------------------------------------------------------

def degree_sort(csr: CSR, descending: bool = True) -> Reordering:
    """Rows ordered by nnz (stable); columns untouched."""
    lengths = csr.row_lengths().astype(np.int64)
    key = -lengths if descending else lengths
    perm = stable_argsort(key, csr.device).astype(np.int64)
    return Reordering(
        row_perm=perm,
        col_perm=np.arange(csr.n_cols, dtype=np.int64),
        strategy="degree-sort",
        params={"descending": descending},
        stats={"max_nnz_row": int(lengths.max()) if lengths.size else 0},
    )


# ---------------------------------------------------------------------------
# Column / cache blocking of the x working set
# ---------------------------------------------------------------------------

def cache_block(csr: CSR, rows_per_block: int = 1024) -> Reordering:
    """Columns ordered by (row block that first touches them, access
    count descending, id); rows untouched."""
    rows, cols = _coords(csr)
    n_cols = csr.n_cols
    first_block = np.full(n_cols, csr.n_rows // rows_per_block + 1,
                          dtype=np.int64)
    np.minimum.at(first_block, cols, rows // rows_per_block)
    counts = np.bincount(cols, minlength=n_cols)
    col_perm = np.lexsort((np.arange(n_cols), -counts, first_block))
    touched = int((counts > 0).sum())
    return Reordering(
        row_perm=np.arange(csr.n_rows, dtype=np.int64),
        col_perm=col_perm.astype(np.int64),
        strategy="cache-block",
        params={"rows_per_block": rows_per_block},
        stats={"touched_cols": touched},
    )


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

def chain(*strategies: Strategy) -> Strategy:
    """Compose strategies left to right: each runs on the matrix as
    permuted by its predecessors; the result is the single equivalent
    permutation pair."""
    def run(csr: CSR) -> Reordering:
        combined = identity_reordering(csr.n_rows, csr.n_cols)
        cur = csr
        names = []
        for strat in strategies:
            step = strat(cur)
            step.validate()
            cur = step.apply(cur)
            names.append(step.strategy)
            combined = combined.then(step)
        return Reordering(
            row_perm=combined.row_perm, col_perm=combined.col_perm,
            strategy=f"chain({','.join(names)})" if names else "identity",
            params=combined.params, stats=combined.stats)
    return run


def identity(csr: CSR) -> Reordering:
    return identity_reordering(csr.n_rows, csr.n_cols)


STRATEGIES: Dict[str, Strategy] = {
    "none": identity,
    "rcm": rcm,
    "degree-sort": degree_sort,
    "cache-block": cache_block,
    "rcm+cache-block": chain(rcm, cache_block),
}

__all__ = ["Strategy", "STRATEGIES", "rcm", "degree_sort", "cache_block",
           "chain", "identity"]
