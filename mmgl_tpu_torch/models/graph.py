"""Graph position encodings: the GCN over the page graph (torch), and the
page-graph helpers on the host (numpy): adjacency, GCN normalization and the
Laplacian position encoding.

``GCN`` is the counterpart of mmgl_tpu/models/graph.py:25-50; the numpy
helpers are a copy of its :52-94, which the data assembler needs
(data/assemble.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmgl_tpu_torch.models.layers import Linear


class GCN(nn.Module):
    """Two rounds of concat(self, adjacency-aggregated) -> bias-free dense,
    ReLU between, over the neighbors with a null root node (the target
    section, index 0 of the adjacency) prepended; returns the embeddings
    without the root. Module names follow the flax paths (``w1``, ``w2``)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.w1 = Linear(2 * input_dim, hidden_dim, bias=False,
                         compute_dtype=compute_dtype)
        self.w2 = Linear(2 * hidden_dim, output_dim, bias=False,
                         compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x: (B, N, D) neighbor embeddings; adj: (B, N+1, N+1) normalized.
        Returns (B, N, output_dim) in the compute dtype."""
        b, _, d = x.shape
        x = x.to(self.compute_dtype)
        x = torch.cat([x.new_zeros(b, 1, d), x], dim=1)     # (B, N+1, D)
        adj = adj.to(x.dtype)
        x = F.relu(self.w1(torch.cat([x, adj @ x], dim=-1)))
        x = self.w2(torch.cat([x, adj @ x], dim=-1))
        return x[:, 1:]


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
