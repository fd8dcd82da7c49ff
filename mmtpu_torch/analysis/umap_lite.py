"""Compact UMAP (McInnes, Healy & Melville 2018) on the card (counterpart of
`mmtpu/analysis/umap_lite.py`, which takes its kNN from sklearn's
`NearestNeighbors`; the card's machine has no sklearn).

The same algorithm, step for step, as tensors on `device` (the card
unless the CPU is asked for):

1. the exact kNN graph: float64 distances by `torch.cdist` (no matrix
   product shortcut) and `topk`, the point itself dropped, the distances
   rounded as sklearn's;
2. the smooth-kNN calibration: every row's binary search for sigma,
   sum_j exp(-(d_ij - rho_i)/sigma_i) = log2(k), run for all rows at once,
   each row stopping where mmtpu's loop breaks;
3. the fuzzy simplicial set's union a + b - ab over the directed edges and
   their transposes, its edges in scipy's row-major order, zeros dropped;
4. the layout by SGD on the cross-entropy, with negative sampling:
   `index_add_` in place of `np.add.at`.

What the layout draws and when stays mmtpu's, so the layout follows its
step for step: the PCA start (numpy's float32 SVD), the (a, b) fit (scipy),
the edges' update schedule (float64, on the host: it reads the weights
alone) and the negative samples, drawn on the host from
`np.random.default_rng(random_state)` in mmtpu's order. The layout is
float32 and its coefficients a, b float64 Python scalars, as in mmtpu.
Deterministic on the CPU; on the card `index_add_` sums a point's updates
in no fixed order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


def _knn(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, distances) of every point's k nearest others, nearest
    first: ranked by the float64 distance, and given as sklearn gives them
    for float32 points (the float64 squared distance rounded to float32,
    its float32 square root), as float64."""
    x64 = x.double()
    dist = torch.cdist(x64, x64, compute_mode="donot_use_mm_for_euclid_dist")
    d, idx = torch.topk(dist, k + 1, dim=1, largest=False, sorted=True)
    # the square root of the float32 value, correctly rounded (torch's
    # float32 sqrt on the CPU is not, by an ulp now and then)
    return idx[:, 1:], torch.sqrt(d[:, 1:].square().float().double()).float().double()


def _smooth_knn_dist(distances: torch.Tensor, k: float, n_iter: int = 64):
    """Per point (rho, sigma), float64: rho = the nearest nonzero distance;
    sigma solves sum_j exp(-(d_ij - rho)/sigma) = log2(k) by mmtpu's
    bisection, all rows together (a row that has met the tolerance keeps
    its sigma)."""
    d = distances.double()
    target = float(np.log2(k))
    nonzero = d > 0.0
    count = nonzero.sum(dim=1)
    inf = torch.full_like(d, float("inf"))
    rho = torch.where(count > 0, torch.where(nonzero, d, inf).min(dim=1).values,
                      torch.zeros_like(d[:, 0]))
    lo = torch.zeros_like(rho)
    hi = torch.full_like(rho, float("inf"))
    mid = torch.ones_like(rho)
    active = torch.ones_like(rho, dtype=torch.bool)
    excess = torch.clamp(d - rho[:, None], min=0.0)
    for _ in range(n_iter):
        psum = torch.exp(-excess / mid[:, None]).sum(dim=1)
        active = active & ((psum - target).abs() >= SMOOTH_K_TOLERANCE)
        above = active & (psum > target)
        below = active & ~(psum > target)
        hi = torch.where(above, mid, hi)
        lo = torch.where(below, mid, lo)
        mid = torch.where(above | (below & torch.isfinite(hi)), (lo + hi) / 2.0,
                          torch.where(below, mid * 2.0, mid))
    row_mean = torch.where(count > 0, (d * nonzero).sum(dim=1) / count.clamp(min=1),
                           d.mean())
    sigma = torch.maximum(mid, MIN_K_DIST_SCALE * row_mean)
    return rho, sigma


def _fuzzy_simplicial_set(idx: torch.Tensor, dist: torch.Tensor):
    """Directed membership strengths → their symmetric union a + b - ab:
    (head, tail, weight), the edges in row-major order (scipy's COO of the
    CSR sum), float64 weights, zeros dropped."""
    n, k = idx.shape
    rho, sigma = _smooth_knn_dist(dist, k)
    rows = torch.arange(n, device=idx.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    vals = torch.exp(-torch.clamp(dist.reshape(-1).double() - rho[rows], min=0.0)
                     / sigma[rows])
    keys = torch.cat([rows * n + cols, cols * n + rows])
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    a = torch.zeros(uniq.shape[0], dtype=torch.float64, device=idx.device)
    b = torch.zeros_like(a)
    a[inverse[:n * k]] = vals
    b[inverse[n * k:]] = vals
    sym = (a + b) - a * b
    keep = sym != 0.0
    uniq, sym = uniq[keep], sym[keep]
    return uniq // n, uniq % n, sym


def _find_ab(min_dist: float, spread: float = 1.0):
    """Least-squares fit of 1/(1+a d^{2b}) to the desired offset-exponential
    membership curve (scipy, on the host)."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=5000)
    return float(a), float(b)


def _pca_start(x: np.ndarray, n_components: int) -> np.ndarray:
    """mmtpu's start: the first principal components of float32 x (numpy's
    SVD), scaled to a max |value| of 10, float32."""
    centered = x - x.mean(0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    emb = centered @ vt[:n_components].T
    return (emb / max(np.abs(emb).max(), 1e-12) * 10.0).astype(np.float32)


def _layout(emb: torch.Tensor, head: torch.Tensor, tail: torch.Tensor, weight: np.ndarray,
            a: float, b: float, n_epochs: int, learning_rate: float,
            negative_sample_rate: int, rng: np.random.Generator,
            epochs: Optional[int] = None) -> torch.Tensor:
    """mmtpu's SGD over the kept edges (head, tail on emb's device; their
    float64 weights on the host), in place on `emb`, for `epochs` of the
    `n_epochs` schedule (all of them by default)."""
    n = emb.shape[0]
    dev = emb.device
    # per-edge update cadence ∝ membership strength
    epochs_per_sample = weight.max() / weight
    next_update = epochs_per_sample.copy()
    for epoch in range(1, (n_epochs if epochs is None else epochs) + 1):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        active = next_update <= epoch
        if not active.any():
            continue
        sel = torch.from_numpy(np.flatnonzero(active)).to(dev)
        hs, ts = head[sel], tail[sel]
        diff = emb[hs] - emb[ts]
        d2 = torch.sum(diff ** 2, dim=1)
        grad_coef = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2 ** b)
        grad = torch.clamp(grad_coef[:, None] * diff, -4, 4)
        emb.index_add_(0, hs, alpha * grad)
        emb.index_add_(0, ts, -alpha * grad)
        # negative sampling
        for _ in range(negative_sample_rate):
            ns = torch.from_numpy(rng.integers(0, n, hs.shape[0])).to(dev)
            diff_n = emb[hs] - emb[ns]
            d2n = torch.sum(diff_n ** 2, dim=1) + 1e-3
            rep = (2.0 * b) / (d2n * (1.0 + a * d2n ** b))
            grad_n = torch.clamp(rep[:, None] * diff_n, -4, 4)
            emb.index_add_(0, hs, alpha * grad_n)
        next_update[active] += epochs_per_sample[active]
    return emb


def umap_embed(
    x: np.ndarray,
    n_components: int = 2,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_epochs: int = 200,
    learning_rate: float = 1.0,
    negative_sample_rate: int = 5,
    random_state: int = 42,
    device=None,
) -> np.ndarray:
    """UMAP embedding of x (n, d) → (n, n_components), float32, computed on
    `device` (the card by default; "cpu" on the host)."""
    device = torch.device("cuda" if device is None else device)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    k = min(n_neighbors, n - 1)
    rng = np.random.default_rng(random_state)

    idx, dist = _knn(torch.from_numpy(x).to(device), k)
    head, tail, weight = _fuzzy_simplicial_set(idx, dist)
    a, b = _find_ab(min_dist)
    emb = torch.from_numpy(_pca_start(x, n_components)).to(device)

    weight = weight.cpu().numpy()
    keep = weight > weight.max() / max(n_epochs, 1)
    sel = torch.from_numpy(np.flatnonzero(keep)).to(device)
    _layout(emb, head[sel], tail[sel], weight[keep], a, b, n_epochs, learning_rate,
            negative_sample_rate, rng)
    return emb.cpu().numpy()
