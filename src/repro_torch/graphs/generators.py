"""Synthetic graph generators.

``rmat`` mirrors the Graph500 Kronecker generator used for the paper's
*kron* dataset (scale 25, edge factor ~31). ``icosahedral_multimesh``
is GraphCast's mesh and ``batched_molecules`` the GNNs' ``molecule``
regime. All generators are deterministic given ``seed`` and draw from
numpy's ``default_rng``, so a seed gives the same arrays as the JAX
package's generators.
"""
from __future__ import annotations

import numpy as np

from .formats import Graph, from_edge_list


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 0,
         dedup: bool = False) -> Graph:
    """R-MAT / Graph500 Kronecker graph: 2**scale nodes."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        # quadrant choice per Graph500 reference
        go_right = r >= ab            # column bit set
        go_down = ((r >= a) & (r < ab)) | (r >= abc)  # row bit set
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    # permute vertex labels so degree is not correlated with ID
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    if dedup:
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
    return Graph(n, src.astype(np.int32), dst.astype(np.int32))


def uniform_random(num_nodes: int, num_edges: int, *, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    dst = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    return Graph(num_nodes, src.astype(np.int32), dst.astype(np.int32))


def power_law(num_nodes: int, avg_degree: int, *, exponent: float = 2.1,
              seed: int = 0) -> Graph:
    """Chung-Lu style power-law graph (degree ~ pareto)."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(exponent - 1.0, num_nodes) + 1.0
    p = w / w.sum()
    m = num_nodes * avg_degree
    src = rng.choice(num_nodes, size=m, p=p).astype(np.int32)
    dst = rng.choice(num_nodes, size=m, p=p).astype(np.int32)
    return Graph(num_nodes, src, dst)


def grid_2d(rows: int, cols: int) -> Graph:
    """4-neighbor grid, both directions (high locality — the paper's
    *web*-like regime when labeled row-major)."""
    idx = np.arange(rows * cols, dtype=np.int32).reshape(rows, cols)
    e = [np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
         np.stack([idx[:, 1:].ravel(), idx[:, :-1].ravel()], 1),
         np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
         np.stack([idx[1:, :].ravel(), idx[:-1, :].ravel()], 1)]
    return from_edge_list(rows * cols, np.concatenate(e, 0))


# --------------------------------------------------------------------------
# Icosahedral multimesh (GraphCast substrate)
# --------------------------------------------------------------------------
def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 dtype=np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 dtype=np.int64)
    return v, f


def _subdivide(verts: np.ndarray, faces: np.ndarray):
    """One loop-subdivision step on a triangle mesh over the unit sphere."""
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], 0)
    edges = np.sort(edges, axis=1)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mid = verts[uniq[:, 0]] + verts[uniq[:, 1]]
    mid /= np.linalg.norm(mid, axis=1, keepdims=True)
    mid_id = len(verts) + np.arange(len(uniq))
    new_verts = np.concatenate([verts, mid], 0)
    nf = len(faces)
    m01 = mid_id[inv[:nf]]
    m12 = mid_id[inv[nf:2 * nf]]
    m20 = mid_id[inv[2 * nf:]]
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    new_faces = np.concatenate([
        np.stack([a, m01, m20], 1), np.stack([b, m12, m01], 1),
        np.stack([c, m20, m12], 1), np.stack([m01, m12, m20], 1)], 0)
    return new_verts, new_faces


def icosahedral_multimesh(refine: int = 6) -> tuple[np.ndarray, Graph]:
    """GraphCast multimesh: union of edges from all refinement levels.

    Returns (vertex positions on unit sphere, bidirectional edge Graph).
    refine=6 gives 40962 nodes (10*4^6 + 2).
    """
    verts, faces = icosahedron()
    all_edges = []
    for _ in range(refine + 1):
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], 0)
        all_edges.append(np.sort(e, axis=1))
        verts, faces = _subdivide(verts, faces)
    # verts/faces after loop are one level past `refine`; rebuild verts
    # by re-running to the requested level is wasteful — instead note the
    # vertex array only grows, and level-L edges only reference the first
    # 10*4^L+2 vertices.  Use vertices up to the finest requested level.
    n = 10 * 4 ** refine + 2
    edges = np.unique(np.concatenate(all_edges, 0), axis=0)
    edges = np.concatenate([edges, edges[:, ::-1]], 0)
    g = from_edge_list(n, edges)
    return verts[:n], g


def batched_molecules(n_mols: int, atoms_per_mol: int, edges_per_mol: int,
                      *, seed: int = 0) -> tuple[Graph, np.ndarray]:
    """Disjoint union of small random molecular graphs.

    Returns (graph, mol_id per node) — the `molecule` shape regime.
    """
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for i in range(n_mols):
        base = i * atoms_per_mol
        s = rng.integers(0, atoms_per_mol, edges_per_mol)
        d = (s + 1 + rng.integers(0, atoms_per_mol - 1,
                                  edges_per_mol)) % atoms_per_mol
        srcs.append(base + s)
        dsts.append(base + d)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    mol_id = np.repeat(np.arange(n_mols, dtype=np.int32), atoms_per_mol)
    return Graph(n_mols * atoms_per_mol, src, dst), mol_id
