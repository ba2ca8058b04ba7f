"""Generation-quality evaluation: the Frechet distance between two
embedding distributions (own copy of ``domainrag_tpu/eval/fid.py``).

Classic FID uses InceptionV3 pool features; the extractor here is
pluggable and :func:`fid_from_paths` takes the port's own CLIP image
tower (CLIP-FID: the same Frechet machinery in another feature space).
The Frechet core is numpy + scipy and extractor-agnostic.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..core.log import get_logger

logger = get_logger("domainrag_tpu_torch.eval")


def compute_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D))."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^(1/2))."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # (no ``disp=``: newer scipy removed it; without it every version
    # returns the root alone)
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        logger.warning("singular covariance product; adding eps=%g", eps)
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(real: np.ndarray, generated: np.ndarray) -> float:
    mu_r, s_r = compute_stats(real)
    mu_g, s_g = compute_stats(generated)
    return frechet_distance(mu_r, s_r, mu_g, s_g)


def fid_from_paths(real_paths: Sequence[str],
                   generated_paths: Sequence[str],
                   clip_encoder) -> float:
    """CLIP-FID between two image sets, embedded by a
    ``stages.encoders.ClipImageEncoder``."""
    real_feats, _ = clip_encoder.encode_paths(real_paths)
    gen_feats, _ = clip_encoder.encode_paths(generated_paths)
    if len(real_feats) < 2 or len(gen_feats) < 2:
        raise ValueError("need at least 2 readable images per set")
    return fid_from_features(real_feats, gen_feats)
