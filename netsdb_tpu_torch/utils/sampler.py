"""Sampling utilities — the port's copy of ``netsdb_tpu/utils/sampler.py``
(reference ``src/utilities/headers/Sampler.h``); numpy only, the same
draws for the same seed.

The reference uses these to Bernoulli-sample initial centroids for
KMeans/GMM with a probabilistic lower-bound guarantee
(``TestKMeansMLLibCompliant.cc:462-505``, ``TestGmmLazy.cc:425``): pick a
fraction such that a Bernoulli sample of ``total`` items contains at
least ``sample_size_lower_bound`` items with probability ~1-1e-4,
re-sampling if it comes up short, then Fisher-Yates shuffle and truncate.

``SafeResult`` (``src/utilities/headers/SafeResult.h``), the reference's
error-or-value wrapper, has no analogue here on purpose: Python
exceptions are the idiomatic equivalent and are what every API in this
framework raises.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


def num_std(sample_size_lower_bound: int) -> float:
    """Standard-deviation multiplier for the with-replacement bound
    (``Sampler.h:14-22``): tighter for larger sample sizes."""
    if sample_size_lower_bound < 6.0:
        return 12.0
    if sample_size_lower_bound < 16.0:
        return 9.0
    return 6.0


def compute_fraction_for_sample_size(sample_size_lower_bound: int,
                                     total: int,
                                     with_replacement: bool = False) -> float:
    """Bernoulli fraction guaranteeing >= ``sample_size_lower_bound``
    samples out of ``total`` w.h.p. (``Sampler.h:25-41``)."""
    if total <= 0:
        raise ValueError(f"total must be positive, got {total}")
    n = float(sample_size_lower_bound)
    if with_replacement:
        return max(n + num_std(sample_size_lower_bound) * math.sqrt(n),
                   1e-15) / total
    fraction = n / total
    delta = 1e-4
    gamma = -math.log(delta) / total
    return min(1.0, max(1e-10, fraction + gamma +
                        math.sqrt(gamma * gamma + 2 * gamma * fraction)))


def randomize_in_place(items: List, seed: Optional[int] = None) -> None:
    """Fisher-Yates shuffle (``Sampler.h:44-53``)."""
    rng = np.random.default_rng(seed)
    for i in range(len(items) - 1, -1, -1):
        j = int(rng.integers(0, i + 1))
        items[i], items[j] = items[j], items[i]


def bernoulli_sample_rows(points: np.ndarray, fraction: float,
                          seed: Optional[int] = None) -> np.ndarray:
    """Row-wise Bernoulli sample — the ``KMeansSampleSelection`` UDF
    (each point kept independently with probability ``fraction``)."""
    rng = np.random.default_rng(seed)
    mask = rng.random(points.shape[0]) < fraction
    return points[mask]


def sample_k_distinct(points: np.ndarray, k: int,
                      seed: Optional[int] = None) -> np.ndarray:
    """The full MLLib-compliant init (``TestKMeansMLLibCompliant.cc:
    462-530``): Bernoulli-sample until >= k rows, shuffle, truncate to
    k, and drop duplicates (the reference's distinct pass; the returned
    model may therefore have < k rows, as there)."""
    n = points.shape[0]
    if n == 0:
        raise ValueError("cannot sample from an empty point set")
    fraction = compute_fraction_for_sample_size(k, n, with_replacement=False)
    rng = np.random.default_rng(seed)
    samples = np.empty((0, points.shape[1]), dtype=points.dtype)
    while samples.shape[0] < k:
        take = bernoulli_sample_rows(points, fraction,
                                     seed=int(rng.integers(0, 2**31)))
        samples = np.concatenate([samples, take], axis=0)
    idx = list(range(samples.shape[0]))
    randomize_in_place(idx, seed=int(rng.integers(0, 2**31)))
    samples = samples[np.asarray(idx[:k])]
    return np.unique(samples, axis=0)
