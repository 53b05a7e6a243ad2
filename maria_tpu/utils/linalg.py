"""Linear-algebra helpers: pointing-matrix ingredients, PSD inverse,
spatial noise basis.

The pointing "matrix" never materializes on the device: sampling a map is a
bilinear gather and binning a TOD is a segment-sum scatter, both expressed
here as (pixel index, weight) pairs over a Cartesian product of grids
(reference: maria/utils/linalg.py:9-58 builds the same ingredients to feed
a scipy CSR matrix).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import scipy as sp

from ..functions import matern_five_halves

__all__ = [
    "pointing_indices_and_weights",
    "fast_psd_inverse",
    "generate_spatial_basis",
]


def _dim_indices_and_weights(x, side, bilinear: bool):
    """Per-dimension (2 or 1, ...) pixel indices and weights.

    `side` are the pixel-center coordinates (ascending). Nearest mode
    snaps to the closest center; bilinear mode splits between the two
    neighbors. Pure jnp; safe under jit with static `side`.
    """
    side = jnp.asarray(side)
    n = side.shape[0]
    if bilinear:
        # fractional index on the center grid
        lo = jnp.searchsorted(side, x, side="right") - 1
        lo = jnp.clip(lo, 0, n - 2)
        p = (x - side[lo]) / (side[lo + 1] - side[lo])
        inside = (p >= 0) & (p <= 1)
        p = jnp.clip(p, 0.0, 1.0)
        idx = jnp.stack([lo, lo + 1], axis=0)
        wgt = jnp.stack([1 - p, p], axis=0) * inside[None]
        return idx, wgt
    else:
        edges = 0.5 * (side[1:] + side[:-1])
        idx = jnp.searchsorted(edges, x, side="right")
        half = jnp.diff(side).mean() / 2
        inside = (x >= side[0] - half) & (x <= side[-1] + half)
        return idx[None], inside[None].astype(x.dtype)


def pointing_indices_and_weights(x_list, side_list, bilinear=True):
    """Flattened pixel indices and weights for samples over an N-D grid.

    Returns (pixels, weights, n_pixels): `pixels` has shape
    (2^n_bilinear_dims, *sample_shape) of flattened (row-major) pixel
    indices, `weights` the matching bilinear weights (zero for samples
    that fall off the grid). Equivalent information to the reference's
    compute_pointing_matrix_ingredients (utils/linalg.py:9).
    """
    if isinstance(bilinear, bool):
        bilinear = len(x_list) * [bilinear]

    pixels = None
    weights = None
    n_pixels = 1
    for x, side, dim_bilinear in zip(x_list, side_list, bilinear):
        x = jnp.asarray(x)
        side = np.atleast_1d(side)
        if side.size == 1:
            continue
        dim_idx, dim_wgt = _dim_indices_and_weights(x, side, dim_bilinear)
        n_pixels *= side.size
        if pixels is None:
            pixels, weights = dim_idx, dim_wgt
        else:
            # outer product over the leading "corner" axis
            k_prev, k_dim = pixels.shape[0], dim_idx.shape[0]
            pixels = (pixels[:, None] * side.size + dim_idx[None]).reshape(
                k_prev * k_dim, *dim_idx.shape[1:]
            )
            weights = (weights[:, None] * dim_wgt[None]).reshape(
                k_prev * k_dim, *dim_wgt.shape[1:]
            )
    if pixels is None:
        raise ValueError("at least one dimension must have more than one pixel")
    return pixels, weights, n_pixels


# reference-name alias (maria/utils/linalg.py:9)
compute_pointing_matrix_ingredients = pointing_indices_and_weights


def fast_psd_inverse(M: np.ndarray) -> np.ndarray:
    """Cholesky-based inverse for PSD matrices (host, float64).

    Same LAPACK route as the reference (utils/linalg.py:95-102).
    """
    chol, info = sp.linalg.lapack.dpotrf(M)
    if info != 0:
        raise np.linalg.LinAlgError(f"dpotrf failed with info={info}")
    inv, info = sp.linalg.lapack.dpotri(chol)
    if info != 0:
        raise np.linalg.LinAlgError(f"dpotri failed with info={info}")
    return np.where(inv, inv, inv.T)


def generate_spatial_basis(offsets, k: int = 5, n_side: int = 8, scale: float = 1):
    """Low-rank Matérn-5/2 eigenbasis over the focal plane for correlated
    detector noise.

    Provenance: the *recipe* — coarse n_side^2 grid over the detector
    hull, Matérn-5/2 covariance, top-k scaled eigenmodes, cubic
    interpolation back to the detectors — is the reference's
    (maria/utils/linalg.py:105-126); it defines the correlated-noise
    statistics a user switching frameworks expects. The implementation
    here uses a symmetric eigendecomposition (C is PSD) rather than the
    reference's full SVD.
    """
    lo = offsets.min(axis=0)
    hi = offsets.max(axis=0)
    x = np.linspace(lo[0], hi[0], n_side)
    y = np.linspace(lo[1], hi[1], n_side)
    grid = np.stack(np.meshgrid(x, y, indexing="ij"), axis=-1).reshape(-1, 2)
    dist = np.linalg.norm(grid[:, None] - grid[None, :], axis=-1) / max(scale, 1e-16)
    # eigh returns ascending order; the strongest k modes are the last k
    evals, evecs = np.linalg.eigh(matern_five_halves(dist))
    modes = evecs[:, : -k - 1 : -1] * np.sqrt(np.maximum(evals[: -k - 1 : -1], 0.0))
    B = sp.interpolate.RegularGridInterpolator(
        (x, y), modes.reshape(n_side, n_side, k), method="cubic"
    )(offsets)
    B *= np.sign(B[:, 0].mean() or 1.0)  # deterministic overall sign
    return B


def compute_pointing_matrix_sparse_indices(x_list, bins_list):
    """(sample_indices, pixel_indices, n_pixels) binning samples onto the
    Cartesian product of `bins_list` edges, dropping samples that fall
    outside any dimension (reference: utils/linalg.py:61-92)."""
    for bins in bins_list:
        if not np.all(np.diff(bins) > 0):
            raise ValueError("Each set of bins must be strictly increasing.")
    flat = [np.ravel(np.asarray(x)) for x in x_list]
    pixel = np.zeros(flat[0].shape, dtype=np.int64)
    inside = np.ones(flat[0].shape, dtype=bool)
    n_pixels = 1
    for x, bins in zip(flat, bins_list):
        i = np.digitize(x, bins=bins) - 1
        inside &= (i >= 0) & (i < len(bins) - 1)
        pixel = pixel * (len(bins) - 1) + np.clip(i, 0, len(bins) - 2)
        n_pixels *= len(bins) - 1
    sample_indices = np.nonzero(inside)[0]
    return sample_indices, pixel[inside], n_pixels
