"""Brute-force descriptor matching with spatial-jump penalty and ratio test.

Reference semantics (``src/frontend/feature_matcher.cpp:71-204``):

  * for each query descriptor, the best and second-best Hamming distances
    over all train descriptors;
  * **spatial-jump penalty**: when keypoints are supplied and the pixel
    distance between a candidate pair exceeds ``MAX_JUMP_RADIUS`` (500), the
    integer distance is scaled by ``1 + d/500`` and truncated back to int
    (``feature_matcher.cpp:161-170``);
  * Lowe ratio test: drop the match if ``best >= thr · secondBest``
    (``:176-182``);
  * optional global top-``GoodMatchesCount`` filter by distance (``:191-204``).

Accelerator-first restructuring: the whole N1×N2 penalised distance matrix
is produced in one bit-matmul + elementwise pass; best/second-best are two
masked min-reductions; the top-K filter is one ``top_k``.  Output is a
fixed-capacity ``MatchSet`` (padded + masked) so the matcher ``vmap``s over
batches of frame pairs.
"""

from __future__ import annotations

import os
from functools import partial
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuslam.common.hamming import hamming_matrix
from tpuslam.config.schema import MatcherConfig
from tpuslam.frontend.fast import KeypointSet

_INT_MAX = jnp.iinfo(jnp.int32).max
# Data-movement layout of the (N1, N2) distance matrix (the matcher moves
# more bytes than any other stage of the VO chunk).  The optimised layout is semantics-identical (oracle tests
# unchanged): int16 distances (max penalised distance ≤ 1016 ≪ 32767),
# second-best by equality-masked min instead of a scatter knockout (the
# .at[].set rewrite materialised the full matrix twice), and the pixel
# distance d² from a (N1,2)×(2,N2) matmul expansion instead of the
# (N1, N2, 2) broadcast-subtract tensor.  TPUSLAM_MATCH_LEGACY=1 restores
# the round-4 layout (the interleaved A/B comparator).
_LEGACY = os.environ.get("TPUSLAM_MATCH_LEGACY") == "1"
# int16 sentinel: larger than any real (penalised) distance, small enough
# that packed ratio/top-k float math stays exact.
_SENT16 = jnp.int16(32767)


class MatchSet(NamedTuple):
    """Fixed-capacity match buffer (pytree)."""

    query_idx: jax.Array  # (..., M) int32
    train_idx: jax.Array  # (..., M) int32
    distance: jax.Array  # (..., M) float32 (penalised int distance)
    valid: jax.Array  # (..., M) bool

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)


def penalized_distance_matrix(
    dist: jax.Array,
    xy1: jax.Array,
    xy2: jax.Array,
    max_jump_radius: float,
) -> jax.Array:
    """Apply the spatial-jump penalty to an int32 Hamming matrix.

    ``dist``: (N1, N2) int32; ``xy1``: (N1, 2); ``xy2``: (N2, 2).
    dist ← int(dist · (1 + d/R)) when pixel distance d > R (trunc toward 0),
    mirroring reference ``feature_matcher.cpp:161-170``.
    """
    if _LEGACY:
        d2 = jnp.sum((xy1[:, None, :] - xy2[None, :, :]) ** 2, axis=-1)
    else:
        # ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b: the cross term is a (N1,2)×(2,N2)
        # matmul, so no (N1, N2, 2) difference tensor exists.  The
        # expansion's cancellation error (~0.25 px² at KITTI coordinate
        # magnitudes) only matters near d≈0, far from the penalty
        # threshold (d > 500 px) where the value is actually used.
        cross = jnp.matmul(xy1, xy2.T, precision="highest")
        d2 = (
            jnp.sum(xy1 * xy1, axis=-1)[:, None]
            + jnp.sum(xy2 * xy2, axis=-1)[None, :]
            - 2.0 * cross
        )
        d2 = jnp.maximum(d2, 0.0)
    d = jnp.sqrt(d2.astype(jnp.float32))
    penalty = 1.0 + d / max_jump_radius
    penalized = (dist.astype(jnp.float32) * penalty).astype(dist.dtype)
    return jnp.where(d > max_jump_radius, penalized, dist)


@partial(
    jax.jit,
    static_argnames=(
        "use_ratio_test",
        "filter_matches",
        "good_matches_count",
        "use_spatial_penalty",
    ),
)
def match_descriptors(
    desc1: jax.Array,
    desc2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    xy1: jax.Array | None = None,
    xy2: jax.Array | None = None,
    *,
    ratio_threshold: float = 0.5,
    max_jump_radius: float = 500.0,
    use_ratio_test: bool = True,
    filter_matches: bool = True,
    good_matches_count: int = 20,
    use_spatial_penalty: bool = True,
) -> MatchSet:
    """Match query (N1, B) against train (N2, B) descriptors.

    Invalid rows (``valid1``/``valid2`` False) never match.  Output capacity
    is ``good_matches_count`` when filtering, else N1.
    """
    n1 = desc1.shape[0]

    dist = hamming_matrix(desc1, desc2)  # (N1, N2) int32
    if not _LEGACY:
        # int16 layout: max penalised distance is 256·(1 + diag/500) ≤
        # 1016 at KITTI resolution — half the HBM traffic on every
        # materialisation of the (N1, N2) matrix.
        dist = dist.astype(jnp.int16)
    sent = _INT_MAX if _LEGACY else _SENT16
    if use_spatial_penalty and xy1 is not None and xy2 is not None:
        dist = penalized_distance_matrix(dist, xy1, xy2, max_jump_radius)

    # Mask out invalid train columns with the sentinel (reference: INT_MAX).
    dist = jnp.where(valid2[None, :], dist, sent)

    best = jnp.min(dist, axis=1)  # (N1,)
    best_idx = jnp.argmin(dist, axis=1).astype(jnp.int32)  # first occurrence, like C++ <
    if _LEGACY:
        # Second best: min with the best column knocked out (scatter).
        knocked = dist.at[jnp.arange(n1), best_idx].set(sent)
        second = jnp.min(knocked, axis=1)
    else:
        # Equality-masked min: same first-occurrence-knockout semantics
        # without the scatter, which forced a second full read+write of
        # the matrix (the round-4 LC-ring lesson at matcher scale).
        col = jnp.arange(dist.shape[1], dtype=jnp.int32)
        second = jnp.min(
            jnp.where(col[None, :] == best_idx[:, None], sent, dist), axis=1
        )

    good = valid1 & (best < sent)
    if use_ratio_test:
        good = good & (
            best.astype(jnp.float32) < ratio_threshold * second.astype(jnp.float32)
        )

    query_idx = jnp.arange(n1, dtype=jnp.int32)
    distance = best.astype(jnp.float32)

    if not filter_matches:
        return MatchSet(
            query_idx=query_idx,
            train_idx=jnp.where(good, best_idx, -1),
            distance=jnp.where(good, distance, jnp.inf),
            valid=good,
        )

    # Global top-K by (distance asc, query_idx asc): negate a packed key.
    k = min(good_matches_count, n1)
    key = jnp.where(good, distance, jnp.float32(jnp.inf))
    # top_k on -(distance) with query-index tiebreak via tiny epsilon-free
    # trick: distances are integers, so scale by n1 and add the index.
    packed = jnp.where(
        good,
        key * jnp.float32(n1) + query_idx.astype(jnp.float32),
        jnp.float32(jnp.inf),
    )
    _, order = jax.lax.top_k(-packed, k)
    sel_valid = good[order]
    return MatchSet(
        query_idx=jnp.where(sel_valid, query_idx[order], -1),
        train_idx=jnp.where(sel_valid, best_idx[order], -1),
        distance=jnp.where(sel_valid, distance[order], jnp.inf),
        valid=sel_valid,
    )


class FeatureMatcher:
    """Config-bound facade mirroring the reference ``FeatureMatcher``."""

    def __init__(self, config: MatcherConfig | str | Path):
        if not isinstance(config, MatcherConfig):
            config = MatcherConfig.from_yaml(config)
        if config.distance_type != "HAMMING":
            # The reference's L2 path is unreachable from its public uint8
            # API (feature_matcher.cpp:83-87 throws); we keep the same contract.
            raise ValueError("L2 distance requires float descriptors. Use the float overload.")
        self.config = config

    def match(
        self,
        desc1: jax.Array,
        desc2: jax.Array,
        kps1: KeypointSet | None = None,
        kps2: KeypointSet | None = None,
        valid1: jax.Array | None = None,
        valid2: jax.Array | None = None,
    ) -> MatchSet:
        c = self.config
        if valid1 is None:
            valid1 = kps1.valid if kps1 is not None else jnp.ones(desc1.shape[0], bool)
        if valid2 is None:
            valid2 = kps2.valid if kps2 is not None else jnp.ones(desc2.shape[0], bool)
        xy1 = kps1.xy if kps1 is not None else None
        xy2 = kps2.xy if kps2 is not None else None
        return match_descriptors(
            desc1,
            desc2,
            valid1,
            valid2,
            xy1,
            xy2,
            ratio_threshold=c.ratio_test_threshold,
            max_jump_radius=c.max_jump_radius,
            use_ratio_test=c.use_ratio_test,
            filter_matches=c.filter_matches,
            good_matches_count=c.good_matches_count,
            use_spatial_penalty=xy1 is not None and xy2 is not None,
        )
