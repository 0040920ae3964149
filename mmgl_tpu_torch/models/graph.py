"""Page-graph helpers on the host (numpy): adjacency, GCN normalization and
the Laplacian position encoding.

Copy of the numpy half of mmgl_tpu/models/graph.py (:52-94), which the data
assembler needs (data/assemble.py). The torch GCN joins these in a later
change.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def edges_to_dense_adjacency(edge_list: List[Tuple[int, int]],
                             node_num: int) -> np.ndarray:
    """Symmetric dense adjacency from the page-graph edge list (numpy, host)."""
    adj = np.zeros((node_num, node_num), np.float32)
    for a, b in edge_list:
        if a < node_num and b < node_num:
            adj[a, b] = 1.0
            adj[b, a] = 1.0
    return adj


def normalize_graph(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (A + I) D^-1/2 — the intended utils.normalize_graph (Q4)."""
    a = adj + np.eye(adj.shape[0], dtype=adj.dtype)
    deg = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    return (a * d_inv_sqrt[:, None]) * d_inv_sqrt[None, :]


def compute_laplacian_pe(adj: np.ndarray, k: int) -> np.ndarray:
    """k smallest non-trivial eigenvectors of the sym-normalized Laplacian.

    Returns (node_num, k) with deterministic sign (first nonzero entry >= 0).
    The intended utils.compute_LPE (Q4).
    """
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = np.eye(n, dtype=np.float32) - (
        (adj * d_inv_sqrt[:, None]) * d_inv_sqrt[None, :])
    # isolated nodes: D=0 rows become identity rows, eigvec support still fine
    vals, vecs = np.linalg.eigh(lap.astype(np.float64))
    order = np.argsort(vals)
    vecs = vecs[:, order][:, 1 : k + 1]               # drop the trivial mode
    if vecs.shape[1] < k:                             # tiny graphs: pad zeros
        vecs = np.pad(vecs, ((0, 0), (0, k - vecs.shape[1])))
    # sign convention for determinism
    for j in range(vecs.shape[1]):
        col = vecs[:, j]
        nz = np.flatnonzero(np.abs(col) > 1e-9)
        if nz.size and col[nz[0]] < 0:
            vecs[:, j] = -col
    return vecs.astype(np.float32)
