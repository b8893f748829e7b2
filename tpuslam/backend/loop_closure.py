"""Loop closure: BoW place recognition + RANSAC DLT-PnP geometric verification.

Reference semantics (``src/backend/loop_closure.cpp``):

  * ``addKeyframe``: store BoW vector, keypoints, descriptors and 3D map
    points per keyframe id (``:96-109``);
  * ``detect``: gate on database size (``MinDbSize``), skip frames within
    ``MinFramesDifference`` of the *last added* keyframe, find best and
    second-best BoW scores, require ``maxScore ≥ MinAbsoluteScore`` and
    ``maxScore ≥ RelativeScoreFactor · secondMaxScore`` (``:111-151``);
  * geometric verification: re-match query vs candidate descriptors, gate on
    ``MinMatchesForPnP``, RANSAC DLT-PnP, success iff inliers ≥
    ``MinInliersForPnP`` → ``LoopResult{matchedKeyframeId, 4×4 transform}``
    (``:153-236``).

Accelerator-first restructuring: the keyframe database is a fixed-capacity ring of
arrays (a pytree, donate-updatable under jit); BoW scoring over the whole
database is one matvec; all ``optional``-style gates become boolean flags in
the result so the caller composes the detector into jitted pipelines without
data-dependent control flow.  fbow is replaced by the trained binary
vocabulary of :mod:`tpuslam.backend.vocabulary`.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuslam.backend.pnp import ransac_pnp
from tpuslam.backend.vocabulary import Vocabulary
from tpuslam.config.schema import LoopClosureConfig, MatcherConfig
from tpuslam.frontend.matcher import match_descriptors


class KeyframeDB(NamedTuple):
    """Fixed-capacity keyframe database (pytree of device arrays)."""

    bow: jax.Array  # (C, W) float32 — L2-normalised TF-IDF vectors
    xy: jax.Array  # (C, K, 2) float32 — keypoint pixel coords
    kp_valid: jax.Array  # (C, K) bool
    descriptors: jax.Array  # (C, K, B) uint8
    map_points: jax.Array  # (C, K, 3) float32 — 3D points per keypoint
    mp_valid: jax.Array  # (C, K) bool — keypoint has a valid 3D map point
    pose: jax.Array  # (C, 4, 4) float32 — T_world_cam at insert (relocalization
    # anchor; identity when the caller tracks no absolute poses)
    ids: jax.Array  # (C,) int32 — keyframe ids (-1 = empty slot)
    count: jax.Array  # () int32 — number of stored keyframes
    last_id: jax.Array  # () int32 — id of the last added keyframe

    @property
    def capacity(self) -> int:
        return self.bow.shape[0]


class LoopResult(NamedTuple):
    """The reference's optional<LoopResult> as explicit flags."""

    matched_keyframe_id: jax.Array  # () int32 (-1 when no loop)
    relative_transform: jax.Array  # (4, 4) float32
    num_inliers: jax.Array  # () int32
    candidate_id: jax.Array  # () int32 — BoW candidate before verification
    bow_score: jax.Array  # () float32
    success: jax.Array  # () bool


def empty_db(
    capacity: int, num_words: int, max_keypoints: int, desc_bytes: int
) -> KeyframeDB:
    return KeyframeDB(
        bow=jnp.zeros((capacity, num_words), jnp.float32),
        xy=jnp.zeros((capacity, max_keypoints, 2), jnp.float32),
        kp_valid=jnp.zeros((capacity, max_keypoints), bool),
        descriptors=jnp.zeros((capacity, max_keypoints, desc_bytes), jnp.uint8),
        map_points=jnp.zeros((capacity, max_keypoints, 3), jnp.float32),
        mp_valid=jnp.zeros((capacity, max_keypoints), bool),
        pose=jnp.broadcast_to(
            jnp.eye(4, dtype=jnp.float32), (capacity, 4, 4)
        ).copy(),
        ids=jnp.full((capacity,), -1, jnp.int32),
        count=jnp.asarray(0, jnp.int32),
        last_id=jnp.asarray(-1, jnp.int32),
    )


class LoopClosure:
    """Config-bound facade mirroring the reference ``LoopClosure``."""

    def __init__(
        self,
        vocabulary: Vocabulary | str | Path,
        config: LoopClosureConfig | str | Path,
        matcher_config: MatcherConfig | None = None,
    ):
        if not isinstance(vocabulary, Vocabulary):
            vocabulary = Vocabulary.load(vocabulary)
        if not isinstance(config, LoopClosureConfig):
            config = LoopClosureConfig.from_yaml(config)
        self.vocabulary = vocabulary
        self.config = config
        self.matcher_config = matcher_config or MatcherConfig()
        self._detect = jax.jit(self._detect_impl)
        self._add = jax.jit(self._add_impl)
        self._process_chunk_jit = jax.jit(self._process_chunk_impl)
        self._relocalize_jit = jax.jit(
            self._relocalize_impl, static_argnames=("budget",)
        )

    def new_db(self, max_keypoints: int, desc_bytes: int = 32) -> KeyframeDB:
        return empty_db(
            self.config.max_keyframes, self.vocabulary.num_words,
            max_keypoints, desc_bytes,
        )

    # --- addKeyframe -------------------------------------------------------------
    def add_keyframe(
        self,
        db: KeyframeDB,
        keyframe_id: jax.Array | int,
        descriptors: jax.Array,
        xy: jax.Array,
        kp_valid: jax.Array,
        map_points: jax.Array,
        mp_valid: jax.Array | None = None,
        pose: jax.Array | None = None,
    ) -> KeyframeDB:
        """Functional insert (ring buffer when capacity is exceeded).

        ``mp_valid`` marks which keypoints carry real 3D map points (defaults
        to ``kp_valid`` — the reference stores a 3D point for every keypoint,
        ``loop_closure.cpp:96-109``).  ``pose`` is the keyframe's T_world_cam
        (the relocalization anchor; defaults to identity).

        Note: this single-keyframe API always recycles FIFO on overflow;
        the production chunk path (``process_chunk``) applies the
        configured ``EvictionPolicy`` (redundancy-aware by default) —
        long-past-capacity workloads should use the chunk path.
        """
        if mp_valid is None:
            mp_valid = kp_valid
        if pose is None:
            pose = jnp.eye(4, dtype=jnp.float32)
        return self._add(
            db, jnp.asarray(keyframe_id, jnp.int32), descriptors, xy, kp_valid,
            map_points, mp_valid, pose,
        )

    def _add_impl(self, db, keyframe_id, descriptors, xy, kp_valid, map_points,
                  mp_valid, pose=None, bow=None, enabled=None):
        """Functional ring insert; ``enabled=False`` is a masked no-op.

        The no-op is a per-row select + in-bounds ``.at[slot].set`` (a
        dynamic-update-slice touching two rows), NOT a whole-DB
        ``jnp.where`` — selecting the full database per scan step costs
        ~30 MB of HBM traffic each iteration (same rationale as
        ``map.insert_keyframe``; ``mode="drop"`` would lower to a scatter).
        """
        slot = db.count % db.capacity
        if bow is None:
            bow = self.vocabulary.transform(descriptors, kp_valid)
        if pose is None:
            pose = jnp.eye(4, dtype=jnp.float32)
        if enabled is None:
            write = lambda buf, new: buf.at[slot].set(new)  # noqa: E731
            count = db.count + 1
            last_id = keyframe_id
        else:
            en = jnp.asarray(enabled)

            def write(buf, new):
                old = buf[slot]
                e = en.reshape((1,) * old.ndim) if old.ndim else en
                return buf.at[slot].set(jnp.where(e, new, old))

            count = db.count + en.astype(jnp.int32)
            last_id = jnp.where(en, keyframe_id, db.last_id)
        return KeyframeDB(
            bow=write(db.bow, bow),
            xy=write(db.xy, xy),
            kp_valid=write(db.kp_valid, kp_valid),
            descriptors=write(db.descriptors, descriptors),
            map_points=write(db.map_points, map_points),
            mp_valid=write(db.mp_valid, mp_valid),
            pose=write(db.pose, jnp.asarray(pose, jnp.float32)),
            ids=write(db.ids, jnp.asarray(keyframe_id, jnp.int32)),
            count=count,
            last_id=last_id,
        )

    # --- detect --------------------------------------------------------------------
    def detect(
        self,
        db: KeyframeDB,
        descriptors: jax.Array,
        xy: jax.Array,
        kp_valid: jax.Array,
        K: jax.Array,
        key: jax.Array | None = None,
    ) -> LoopResult:
        if key is None:
            key = jax.random.PRNGKey(0)
        return self._detect(db, descriptors, xy, kp_valid, K, key)

    def _gates_impl(self, db, bow_q):
        """BoW gates (reference loop_closure.cpp:111-147) — the sequential
        part of detection: one matvec over the DB plus threshold logic.

        Returns ``(best_slot, cand_id, candidate_ok, max_score)``.
        """
        cfg = self.config
        scores = db.bow @ bow_q  # (C,) one matvec over the whole DB

        # Slot must be occupied and at least MinFramesDifference ids away
        # from the last keyframe.
        occupied = db.ids >= 0
        far = jnp.abs(db.last_id - db.ids) >= cfg.min_frames_difference
        eligible = occupied & far
        masked = jnp.where(eligible, scores, -jnp.inf)
        best_slot = jnp.argmax(masked)
        max_score = masked[best_slot]
        # Second-best over keyframes *away from the best candidate*: the
        # reference compares against the raw runner-up (loop_closure.cpp:
        # 137-141), which on self-similar sequences is the true loop's own
        # neighbour — rejecting every correct loop.  Grouping by id distance
        # keeps the gate's intent (reject matches ambiguous across distinct
        # places) without punishing neighbours of the true match.  The
        # literal reference gate is available via SecondBestGrouped: 0
        # (validated against the grouped one in test_loop_closure.py).
        if cfg.second_best_grouped:
            near_best = (
                jnp.abs(db.ids - db.ids[best_slot]) < cfg.min_frames_difference
            )
        else:
            near_best = jnp.arange(db.capacity) == best_slot
        second = jnp.where(eligible & ~near_best, scores, -jnp.inf).max()
        second = jnp.maximum(second, 0.0)  # reference seeds secondMax at 0.0

        db_big_enough = db.count >= cfg.min_db_size
        bow_nonempty = jnp.sum(bow_q) > 0
        candidate_ok = (
            db_big_enough
            & bow_nonempty
            & jnp.any(eligible)
            & (max_score >= cfg.min_absolute_score)
            & (max_score >= cfg.relative_score_factor * second)
        )
        cand_id = jnp.where(candidate_ok, db.ids[best_slot], -1)
        return best_slot, cand_id, candidate_ok, max_score

    def _verify_impl(
        self, descriptors, xy, kp_valid, cand_desc, cand_xy, cand_kp_valid,
        cand_mp, cand_mp_valid, candidate_ok, K, key, ratio_threshold=None,
    ):
        """Geometric verification (reference :153-236): re-match query
        descriptors against the candidate keyframe, then RANSAC DLT-PnP of
        the candidate's 3D map points against the query's 2D points.

        Branch-free (``candidate_ok`` masks the candidate keypoints to
        nothing instead of skipping): inside the per-chunk scan a
        ``lax.cond`` here costs overhead per *scan iteration*
        even on the skip path — batching verification for all frames
        of a chunk outside the scan (``_process_chunk_impl``) is both
        cheaper and branchless.
        """
        cfg = self.config
        mcfg = self.matcher_config
        cand_kp_valid = cand_kp_valid & candidate_ok
        match = match_descriptors(
            descriptors,
            cand_desc,
            kp_valid,
            cand_kp_valid,
            xy,
            cand_xy,
            ratio_threshold=(
                mcfg.ratio_test_threshold
                if ratio_threshold is None
                else ratio_threshold
            ),
            max_jump_radius=mcfg.max_jump_radius,
            use_ratio_test=mcfg.use_ratio_test,
            filter_matches=False,
            use_spatial_penalty=True,
        )
        # Keep only matches whose candidate keypoint carries a 3D point.
        # (Matching ran over the FULL candidate descriptor set so the
        # ratio test is meaningful; restricting the candidate set first
        # would let junk matches through — the reference matches the full
        # set too, loop_closure.cpp:156-158.)
        q = jnp.maximum(match.query_idx, 0)
        t = jnp.maximum(match.train_idx, 0)
        usable = match.valid & cand_mp_valid[t]
        n_matches = jnp.sum(usable.astype(jnp.int32))
        enough_matches = n_matches >= cfg.min_matches_for_pnp

        pts2d = xy[q]  # query 2D (reference :172)
        pts3d = cand_mp[t]  # candidate 3D (:173)

        pnp = ransac_pnp(
            pts3d,
            pts2d,
            usable & enough_matches,
            K,
            key,
            # The reference's RansacMaxIterations (100) assumes sequential
            # early-exit RANSAC; batched evaluation is one-shot, so use it
            # as a floor and score at least 512 hypotheses (essentially
            # free — one extra batched solve).
            num_hypotheses=max(cfg.ransac_max_iterations, 512),
            sample_size=6,
            reproj_threshold=cfg.ransac_reprojection_threshold,
            min_inliers=cfg.min_inliers_for_pnp,
            # Shallow hypothesis solves + Gauss-Newton LO: the verification
            # PnP's latency is its sequential Jacobi chain (the parallel
            # width is tiny), so the same short-chain split as the tracking
            # PnP applies — 3-sweep hypotheses seed the vote, GN polishes
            # the winner on the true pixel residual.
            hyp_sweeps=6,
            lo_rounds=2,
            refine="gn",
        )
        ok = candidate_ok & enough_matches & pnp.success
        T = jnp.eye(4, dtype=jnp.float32)
        T = T.at[:3, :3].set(pnp.R).at[:3, 3].set(pnp.t)
        return ok, T, pnp.num_inliers

    def _gather_candidate(self, db, best_slot):
        """Point-in-time snapshot of the candidate keyframe's arrays."""
        return (
            db.descriptors[best_slot],
            db.xy[best_slot],
            db.kp_valid[best_slot],
            db.map_points[best_slot],
            db.mp_valid[best_slot],
        )

    def _detect_impl(self, db, descriptors, xy, kp_valid, K, key, bow_q=None):
        if bow_q is None:
            bow_q = self.vocabulary.transform(descriptors, kp_valid)  # (W,)
        best_slot, cand_id, candidate_ok, max_score = self._gates_impl(db, bow_q)
        cand = self._gather_candidate(db, best_slot)

        # Single-frame API: frames that fail the BoW gates (the vast
        # majority) skip matching + PnP entirely under lax.cond.  (The
        # chunked path deliberately avoids this cond — see _verify_impl.)
        def verify(_):
            return self._verify_impl(
                descriptors, xy, kp_valid, *cand, candidate_ok, K, key
            )

        def skip(_):
            return (
                jnp.asarray(False),
                jnp.eye(4, dtype=jnp.float32),
                jnp.asarray(0, jnp.int32),
            )

        verified, T, num_inliers = jax.lax.cond(candidate_ok, verify, skip, None)
        success = candidate_ok & verified

        return LoopResult(
            matched_keyframe_id=jnp.where(success, cand_id, -1),
            relative_transform=jnp.where(success, T, jnp.eye(4, dtype=jnp.float32)),
            num_inliers=num_inliers,
            candidate_id=cand_id,
            bow_score=jnp.where(jnp.isfinite(max_score), max_score, 0.0),
            success=success,
        )

    # --- relocalization -------------------------------------------------------------
    def _reloc_verify_impl(
        self, descriptors, xy, kp_valid, cand_desc, cand_xy, cand_kp_valid,
        cand_mp, cand_mp_valid, candidate_ok, K, key,
    ):
        """Two-view verification for relocalization (not PnP).

        Loop verification PnPs the candidate's stored per-keypoint 3D
        points because a *revisit* has near-zero baseline to the matched
        keyframe — reprojection there is insensitive to the points' depth
        noise.  Relocalization is the opposite regime: the lost frame may
        sit several baselines away, where one-pair triangulation depth
        error dominates (measured on the KITTI fixture: 4 frames apart,
        only ~38% of stored points reproject within 8 px under the TRUE
        relative pose — RANSAC-PnP finds nothing).  So verify 2D↔2D
        instead: essential-matrix RANSAC over ALL descriptor matches
        (depth-free), then recover the metric baseline from the stored 3D
        depths by robust median ratio — the same depth-ratio trick as the
        tracker's monocular scale propagation (``model/slam.py`` step 7).

        The two regimes are complementary — PnP is exactly right at small
        baseline (and degenerate-proof there, while the essential matrix is
        not), so this runs BOTH and prefers PnP whenever it verifies.

        Returns ``(ok, T, num_inliers)`` with the SAME convention as
        ``_verify_impl``: ``x_query = T·x_cand`` (candidate-camera →
        query-camera), so callers invert identically.
        """
        from tpuslam.frontend.pose import (
            estimate_relative_pose,
            triangulate_matched_points,
        )

        cfg = self.config
        mcfg = self.matcher_config
        # Wide-baseline re-matching needs the classic Lowe ratio, not the
        # consecutive-frame setting (see RelocRatioThreshold in the config).
        ratio = cfg.reloc_ratio_threshold
        key, key_pnp = jax.random.split(key)
        ok_pnp, T_pnp, ni_pnp = self._verify_impl(
            descriptors, xy, kp_valid, cand_desc, cand_xy, cand_kp_valid,
            cand_mp, cand_mp_valid, candidate_ok, K, key_pnp,
            ratio_threshold=ratio,
        )
        cand_kp_valid = cand_kp_valid & candidate_ok
        match = match_descriptors(
            descriptors, cand_desc, kp_valid, cand_kp_valid, xy, cand_xy,
            ratio_threshold=ratio,
            max_jump_radius=mcfg.max_jump_radius,
            use_ratio_test=mcfg.use_ratio_test,
            filter_matches=False,
            use_spatial_penalty=True,
        )
        q = jnp.maximum(match.query_idx, 0)
        t_i = jnp.maximum(match.train_idx, 0)
        pts_c = cand_xy[t_i]
        pts_q = xy[q]
        # 5-point Nistér samples: the lost-frame match pool is small
        # (~80 matches, ~40% inliers) — an 8-point sample is all-inlier
        # with p≈0.1% (success flipped with the PRNG key, measured 1/4
        # seeds); 5-point is p≈1.3% → stable (8/8 seeds).
        res = estimate_relative_pose(
            pts_c, pts_q, match.valid, K, key,
            num_hypotheses=1024,
            sample_size=5,
            inlier_threshold_px=cfg.ransac_reprojection_threshold,
            min_matches=cfg.min_matches_for_pnp,
        )
        # metric scale: stored depth vs unit-baseline triangulated depth
        X_unit = triangulate_matched_points(K, res.R, res.t, pts_c, pts_q)
        z_unit = X_unit[:, 2]
        z_stored = cand_mp[t_i][:, 2]
        scale_ok = (
            match.valid & res.inliers & cand_mp_valid[t_i]
            & (z_unit > 1e-3) & (z_stored > 1e-3)
        )
        ratio = jnp.where(scale_ok, z_stored / jnp.maximum(z_unit, 1e-6),
                          jnp.nan)
        scale = jnp.nanmedian(ratio)
        n_scale = jnp.sum(scale_ok.astype(jnp.int32))
        ok = (
            candidate_ok
            & res.success
            & (n_scale >= cfg.min_inliers_for_pnp)
            & jnp.isfinite(scale)
            & (scale > 0)
        )
        T = jnp.eye(4, dtype=jnp.float32)
        T = T.at[:3, :3].set(res.R).at[:3, 3].set(
            res.t * jnp.where(jnp.isfinite(scale), scale, 1.0)
        )
        # The median depth-ratio scale over the handful of scale-eligible
        # inliers is fragile: one-pair stored depths spread 1.6-4.8× of
        # truth on a fixture keyframe, and whichever side of that spread
        # the ≤10-point median lands on becomes the snap baseline
        # (measured: two PRNG draws of the SAME scene placed the same
        # relocalization 0.1 and 1.8 units from truth).  Polish with
        # seeded Huber-IRLS GN over ALL matched stored points — the
        # annealed robust weights suppress the noisy depths instead of
        # letting them vote in a tiny median.  "World" frame here is the
        # candidate's camera; the seed is the scaled-essential pose, so
        # the wide basin (32 px) only ever tightens the estimate.
        from tpuslam.backend.pnp import motion_pnp

        gn_valid = match.valid & cand_mp_valid[t_i] & (z_stored > 1e-3)
        gn = motion_pnp(
            K, T[:3, :3], T[:3, 3], cand_mp[t_i], pts_q, gn_valid,
            iters=6, min_inliers=cfg.min_inliers_for_pnp,
            huber_schedule=(32.0, 16.0, 8.0, 4.0, 2.0, 2.0),
            reproj_threshold=cfg.ransac_reprojection_threshold,
        )
        T = jnp.where(
            gn.success,
            jnp.eye(4, dtype=jnp.float32)
            .at[:3, :3].set(gn.R).at[:3, 3].set(gn.t),
            T,
        )
        # Path choice by inlier competitiveness, not by "PnP verified":
        # RANSAC-PnP's wide-baseline failure mode is a barely-over-floor
        # verification on noisy one-pair depths (measured: a 4-frame-
        # baseline candidate PnP-"verified" with ~floor inliers while the
        # essential path held 29, and the preferred-PnP snap landed 1.8
        # units short).  At genuine small baseline — PnP's home regime,
        # where the essential translation is degenerate but its epipolar
        # inlier count is spuriously high — BOTH counts are high, so
        # requiring PnP to hold ≥75% of the essential count keeps PnP
        # preferred exactly where it is trustworthy.
        use_pnp = ok_pnp & (
            ~ok
            | (
                ni_pnp.astype(jnp.float32)
                >= 0.75 * res.num_inliers.astype(jnp.float32)
            )
        )
        return (
            ok_pnp | ok,
            jnp.where(use_pnp, T_pnp, T),
            jnp.where(use_pnp, ni_pnp, res.num_inliers),
        )

    def relocalize_chunk(
        self,
        db: KeyframeDB,
        need: jax.Array,  # (B,) bool — frame lost tracking, wants a pose
        descriptors: jax.Array,  # (B, K, D) uint8
        xy: jax.Array,  # (B, K, 2)
        kp_valid: jax.Array,  # (B, K)
        K: jax.Array,  # (3, 3)
        keys: jax.Array,  # (B, 2)
        budget: int = 2,
    ) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
        """Jitted wrapper of :meth:`_relocalize_impl`."""
        return self._relocalize_jit(
            db, need, descriptors, xy, kp_valid, K, keys, budget
        )

    def _relocalize_impl(
        self, db, need, descriptors, xy, kp_valid, K, keys, budget=2,
    ):
        """Global relocalization of lost frames against the keyframe DB.

        The capability the reference's architecture implies but never builds
        (its ``LoopClosure`` computes relative transforms and drops them,
        ``loop_closure.cpp:238-274``): when tracking fails, find the
        best-scoring stored keyframe by BoW — *no* temporal eligibility
        gates, a lost frame may match ANY keyframe including its immediate
        predecessors — verify geometrically (re-match + essential RANSAC +
        depth-ratio scale, see :meth:`_reloc_verify_impl`), and return the
        frame's absolute pose ``T_world_cam = db.pose[best] @ inv(T)``
        (``T`` maps cand-cam → query-cam points, so ``inv(T)`` composes
        poses — same convention as the pose-graph loop edges in
        ``model/system.py``).

        Lost frames are rare, so verification is always compacted to the
        first ``budget`` needy frames of the chunk (the same dense-gather
        trick as the ``verify_budget`` path in ``_process_chunk_impl``).

        Returns ``(ok (B,), T_world_cam (B,4,4), num_inliers (B,),
        matched_id (B,))`` — identity pose and -1 id where relocalization
        failed or wasn't needed.
        """
        cfg = self.config
        B = descriptors.shape[0]
        bow = jax.vmap(self.vocabulary.transform)(
            descriptors, kp_valid & need[:, None]
        )
        occupied = db.ids >= 0
        scores = jnp.where(
            occupied[None, :], bow @ db.bow.T, -jnp.inf
        )  # (B, C)
        best = jnp.argmax(scores, axis=1)
        score = jnp.take_along_axis(scores, best[:, None], 1)[:, 0]
        cand_ok = (
            need
            & jnp.any(occupied)
            & (jnp.sum(bow, axis=1) > 0)
            & (score >= cfg.min_absolute_score)
        )
        cands = self._gather_candidate(db, best)

        # Budget priority: highest BoW score first, NOT frame order — a
        # blind span yields several needy frames whose garbage features
        # still clear the absolute-score gate, and first-come selection
        # lets them exhaust the budget before the first *recoverable*
        # frame (a real revisit scores far higher, e.g. 0.8 vs noise).
        V = max(1, min(budget, B))
        sel = jnp.argsort(jnp.where(cand_ok, -score, jnp.inf))[:V]
        ok_v, T_v, ni_v = jax.vmap(
            self._reloc_verify_impl, in_axes=(0,) * 9 + (None, 0)
        )(
            descriptors[sel], xy[sel], (kp_valid & need[:, None])[sel],
            *(c[sel] for c in cands), cand_ok[sel], K, keys[sel],
        )
        ok = jnp.zeros(B, bool).at[sel].set(ok_v) & cand_ok
        eyeB = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
        T_pnp = eyeB.at[sel].set(T_v)  # (B, 4, 4) world→cam of query vs cand
        num_inliers = jnp.zeros(B, jnp.int32).at[sel].set(ni_v)

        # T_world_cam = pose_cand @ inv(T_pnp) (rigid inverse).
        R = T_pnp[:, :3, :3]
        t = T_pnp[:, :3, 3]
        Rt = jnp.swapaxes(R, -1, -2)
        T_inv = (
            eyeB.at[:, :3, :3].set(Rt)
            .at[:, :3, 3].set(-jnp.einsum("bij,bj->bi", Rt, t))
        )
        T_reloc = jnp.where(
            ok[:, None, None], db.pose[best] @ T_inv, eyeB
        )
        matched = jnp.where(ok, db.ids[best], -1)
        return ok, T_reloc, num_inliers, matched

    # --- whole-chunk scan ---------------------------------------------------------
    def process_chunk(
        self,
        db: KeyframeDB,
        frame_ids: jax.Array,  # (B,) int32
        enabled: jax.Array,  # (B,) bool — frame becomes a keyframe
        descriptors: jax.Array,  # (B, K, D) uint8
        xy: jax.Array,  # (B, K, 2)
        kp_valid: jax.Array,  # (B, K)
        map_points: jax.Array,  # (B, K, 3) per-keypoint 3D points
        mp_valid: jax.Array,  # (B, K)
        K: jax.Array,  # (3, 3)
        keys: jax.Array,  # (B, 2) PRNG keys
        poses: jax.Array | None = None,  # (B, 4, 4) T_world_cam per frame
    ) -> tuple[KeyframeDB, LoopResult]:
        """Detect + insert every keyframe of a chunk in ONE dispatch.

        Replaces the round-1 per-keyframe host loop whose ``bool(success)``
        reads forced a device sync per keyframe.  Detection for frame i sees the database as of frame i−1
        (the reference's detect-then-add order, ``test_loop_closure.cpp``);
        disabled frames leave the database untouched and report no loop.
        Returns the stacked per-frame ``LoopResult`` — the host reads it
        once per chunk.
        """
        return self._process_chunk_jit(
            db, frame_ids, enabled, descriptors, xy, kp_valid, map_points,
            mp_valid, K, keys, poses,
        )

    def _process_chunk_impl(
        self, db, frame_ids, enabled, descriptors, xy, kp_valid, map_points,
        mp_valid, K, keys, poses=None,
    ):
        """Whole-chunk detection + insert, fully batched (no per-frame scan).

        Frame i's sequential database view is "pre-chunk DB + enabled
        frames j<i", so the BoW gates decompose into two batched score
        matrices — query-vs-snapshot (B, C) and query-vs-chunk (B, B) with
        a lower-triangular eligibility mask — instead of B sequential
        matvecs.  The per-frame carried gate state (DB size, last inserted
        id) is a cumsum / prefix-max over the enabled mask.  The insert
        becomes ONE contiguous ring-window blit of the enabled rows (the
        same roll→select→roll-back trick as ``map.insert_points``).  The
        round-2 sequential scan of gates+insert paid per-step small-op
        overhead; this whole path is a few matmuls.

        Exactness caveat (documented deviation): within a chunk that
        overflows the ring (db.count + B > capacity), later frames can
        still match keyframes whose slots earlier chunk frames recycled —
        the scored snapshot is per-chunk, not per-frame.  With the default
        512-keyframe capacity this affects only the already-lossy
        overflow regime; detection there is strictly *wider*, and
        verification still runs on the matched keyframe's stored data.

        Geometric verification stays batched over the chunk and never
        feeds back into the DB (a ``lax.cond`` per frame adds overhead to
        every scan iteration).
        """
        cfg = self.config
        B = descriptors.shape[0]
        C = db.capacity
        if C < B:
            raise ValueError(
                f"keyframe DB capacity {C} < chunk size {B}: the ring-window "
                "insert blit needs one window per chunk"
            )
        int_min = jnp.iinfo(jnp.int32).min + 1

        # One BoW transform per frame: detection masks disabled frames'
        # keypoints to nothing, and transform() of an empty mask is exactly
        # the zero vector — so the detection-side BoW is a masked copy of
        # the insert-side one (half the cost of the transform pair was the
        # duplicate).
        bow_add = jax.vmap(self.vocabulary.transform)(descriptors, kp_valid)
        bow_det = jnp.where(enabled[:, None], bow_add, 0.0)

        # --- per-frame sequential gate state, batched ------------------------
        en_i32 = enabled.astype(jnp.int32)
        ins_before = jnp.cumsum(en_i32) - en_i32  # enabled j<i
        count_i = db.count + ins_before  # DB size frame i sees
        fid_en = jnp.where(enabled, frame_ids, int_min)
        cummax = jax.lax.associative_scan(jnp.maximum, fid_en)
        prev_cummax = jnp.concatenate(
            [jnp.full((1,), int_min, jnp.int32), cummax[:-1]]
        )
        last_id_i = jnp.maximum(db.last_id, prev_cummax)  # (B,)

        # --- BoW scores + eligibility (reference loop_closure.cpp:111-147) ---
        scores_db = bow_det @ db.bow.T  # (B, C)
        scores_in = bow_det @ bow_add.T  # (B, B)
        mfd = cfg.min_frames_difference
        occupied = db.ids >= 0
        elig_db = occupied[None, :] & (
            jnp.abs(last_id_i[:, None] - db.ids[None, :]) >= mfd
        )
        tri = jnp.arange(B)
        elig_in = (
            enabled[None, :]
            & (tri[None, :] < tri[:, None])
            & (jnp.abs(last_id_i[:, None] - frame_ids[None, :]) >= mfd)
        )
        all_scores = jnp.concatenate([scores_db, scores_in], axis=1)
        all_ids = jnp.concatenate([db.ids, frame_ids])  # (C+B,)
        elig = jnp.concatenate([elig_db, elig_in], axis=1)
        masked = jnp.where(elig, all_scores, -jnp.inf)
        best = jnp.argmax(masked, axis=1)  # (B,)
        max_score = jnp.take_along_axis(masked, best[:, None], 1)[:, 0]
        best_ids = all_ids[best]

        # Second-best gate (grouped or literal — see _gates_impl).
        if cfg.second_best_grouped:
            near_best = (
                jnp.abs(all_ids[None, :] - best_ids[:, None]) < mfd
            )
        else:
            near_best = jnp.arange(C + B)[None, :] == best[:, None]
        second = jnp.where(elig & ~near_best, all_scores, -jnp.inf).max(axis=1)
        second = jnp.maximum(second, 0.0)  # reference seeds secondMax at 0.0

        cand_oks = (
            enabled
            & (count_i >= cfg.min_db_size)
            & (jnp.sum(bow_det, axis=1) > 0)
            & jnp.any(elig, axis=1)
            & (max_score >= cfg.min_absolute_score)
            & (max_score >= cfg.relative_score_factor * second)
        )
        cand_ids = jnp.where(cand_oks, best_ids, -1)
        bow_scores = jnp.where(jnp.isfinite(max_score), max_score, 0.0)

        # --- candidate data: DB snapshot or the chunk's own frame ------------
        from_db = best < C
        slot = jnp.clip(best, 0, C - 1)
        j_in = jnp.clip(best - C, 0, B - 1)

        def pick(db_arr, chunk_arr):
            sel = from_db.reshape((B,) + (1,) * (db_arr.ndim - 1))
            return jnp.where(sel, db_arr[slot], chunk_arr[j_in])

        cands = (
            pick(db.descriptors, descriptors),
            pick(db.xy, xy),
            pick(db.kp_valid, kp_valid),
            pick(db.map_points, map_points),
            pick(db.mp_valid, mp_valid),
        )

        # --- batched ring insert: one B-row gather/scatter --------------------
        n_en = jnp.sum(en_i32)
        w0 = db.count % C
        order = jnp.argsort(jnp.where(enabled, tri, B + tri))  # enabled first
        written = tri < n_en  # block rows actually inserted

        if cfg.eviction_policy == "redundancy":
            # Victim selection on overflow (see LoopClosureConfig.
            # eviction_policy): evict the rows whose content the rest of
            # the DB best duplicates.  FIFO would recycle the EARLIEST
            # keyframes — exactly the ones long-sequence loops close
            # against (the reference's DB is unbounded, loop_closure.cpp:
            # 96-109, so it never faces the choice).  Redundancy = max BoW
            # similarity to any other occupied row: one (C, C) self-
            # similarity matmul + top-k, run under a real cond so chunks
            # before overflow pay nothing.  Greedy-per-chunk approximation:
            # the B victims come from one similarity snapshot (a row and
            # its twin can both be evicted in the same chunk); self-similar
            # filler dominates the victim list long before that matters.
            def _fifo_idx(_):
                return (w0 + tri) % C

            def _evict_idx(_):
                R = jnp.matmul(db.bow, db.bow.T, precision="highest")
                pair_ok = (
                    occupied[:, None]
                    & occupied[None, :]
                    & ~jnp.eye(C, dtype=bool)
                )
                red = jnp.max(jnp.where(pair_ok, R, -jnp.inf), axis=1)
                red = jnp.where(jnp.isfinite(red), red, 0.0)
                protect = occupied & (
                    db.ids > db.last_id - cfg.eviction_protect_recent
                )
                score = jnp.where(occupied, red, jnp.inf)  # empties first
                # Protected rows are last-resort victims.  Config
                # validation (SlamConfig.__post_init__) guarantees ≥B
                # unprotected rows per chunk for loaded configs; for
                # hand-built edge cases the last resort is deterministic
                # oldest-first (finite sub-floor score ordered by age)
                # instead of lax.top_k's arbitrary pick among -inf ties.
                age = (db.last_id - db.ids).astype(jnp.float32)
                score = jnp.where(protect, -1e30 + age, score)
                _, idx = jax.lax.top_k(score, B)
                return idx.astype(jnp.int32)

            ins_idx = jax.lax.cond(
                db.count + n_en > C, _evict_idx, _fifo_idx, None
            )
        else:  # fifo: contiguous ring window
            ins_idx = (w0 + tri) % C

        def blit(target, block):
            # Touch ONLY the B candidate rows: gather their current values,
            # overwrite the first n_en with the enabled block, scatter back.
            # The previous roll→concat→roll formulation rewrote the FULL DB
            # (~28 MB across the eight buffers) three times per chunk to
            # insert ≤16 rows; a 16-row scatter is cheap (the ~serial
            # scatter pathology is per-index — 16 indices, not 1024) and
            # XLA aliases the scan carry so the update is in place.
            w = written.reshape((B,) + (1,) * (target.ndim - 1))
            head = jnp.where(w, block, target[ins_idx])
            return target.at[ins_idx].set(head)

        if poses is None:
            poses = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
        db = KeyframeDB(
            bow=blit(db.bow, bow_add[order]),
            xy=blit(db.xy, xy[order]),
            kp_valid=blit(db.kp_valid, kp_valid[order]),
            descriptors=blit(db.descriptors, descriptors[order]),
            map_points=blit(db.map_points, map_points[order]),
            mp_valid=blit(db.mp_valid, mp_valid[order]),
            pose=blit(db.pose, jnp.asarray(poses, jnp.float32)[order]),
            ids=blit(db.ids, frame_ids[order]),
            count=db.count + n_en,
            last_id=jnp.maximum(db.last_id, cummax[-1]),
        )

        # --- geometric verification -------------------------------------------
        # Candidates are rare, yet the vmapped verification program (full
        # K×K re-match + 512-hypothesis RANSAC-PnP per frame) costs the same
        # whether candidate_ok masks it to a no-op or not.  With a
        # verify_budget V < B, gather the (at most V) candidate frames into
        # a dense block, verify only those, and scatter the verdicts back;
        # frames over budget (>V candidates in ONE chunk — temporally
        # redundant for the pose graph) report success=False.
        kpv_en = kp_valid & enabled[:, None]
        V = self.config.verify_budget
        if 0 < V < B:
            # Chunks with no BoW candidate at all (the common case on
            # forward motion — measured 4 of 6 chunks even on the loopy
            # bench clip) skip the whole verification block under one
            # chunk-level ``lax.cond``: the budget-compacted re-match +
            # RANSAC-PnP is the largest single LC line.  This is the chunk-level analog of the
            # relocalization gating — only the (B,K,·) frame arrays cross
            # the branch boundary, not per-frame conds inside a scan (the
            # ``_ba_cond`` pathology).
            def _do_verify(_):
                sel = jnp.argsort(jnp.where(cand_oks, tri, B + tri))[:V]
                verified_v, T_v, ni_v = jax.vmap(
                    self._verify_impl, in_axes=(0,) * 9 + (None, 0)
                )(
                    descriptors[sel], xy[sel], kpv_en[sel],
                    *(c[sel] for c in cands), cand_oks[sel], K, keys[sel],
                )
                verified = jnp.zeros(B, bool).at[sel].set(verified_v)
                T = jnp.broadcast_to(
                    jnp.eye(4, dtype=jnp.float32), (B, 4, 4)
                ).at[sel].set(T_v)
                num_inliers = jnp.zeros(B, jnp.int32).at[sel].set(ni_v)
                return verified, T, num_inliers

            def _skip_verify(_):
                return (
                    jnp.zeros(B, bool),
                    jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4)),
                    jnp.zeros(B, jnp.int32),
                )

            verified, T, num_inliers = jax.lax.cond(
                jnp.any(cand_oks), _do_verify, _skip_verify, None
            )
        else:
            verified, T, num_inliers = jax.vmap(
                self._verify_impl, in_axes=(0,) * 9 + (None, 0)
            )(descriptors, xy, kpv_en, *cands, cand_oks, K, keys)
        success = cand_oks & verified
        eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), T.shape)
        results = LoopResult(
            matched_keyframe_id=jnp.where(success, cand_ids, -1),
            relative_transform=jnp.where(success[:, None, None], T, eye),
            num_inliers=num_inliers,
            candidate_id=cand_ids,
            bow_score=bow_scores,
            success=success,
        )
        return db, results
