"""SlamPipeline: the end-to-end monocular VO/SLAM orchestrator.

The reference declares this layer but never implements it: ``SLAMModel``
has an empty constructor and an undefined ``run()``
(``src/model/model.cpp:5-7``, ``include/slam/model/model.hpp:15-28``); its
intended composition — Camera → Preprocessor → FeatureDetector →
FeatureMatcher → PoseEstimator → Map → Backend → Visualizer — survives only
as commented-out members (``model.hpp:20-27``) and as the de-facto pipeline
in ``test/frontend/test_pose_estimator.cpp:108-212``.  This module invents
the orchestration loop the accelerator way.

Accelerator-first structure (SURVEY §7 step 5):

  * the *frame-parallel* work (undistort, detect, describe, match
    consecutive pairs, two-view RANSAC) is ``vmap``-ed over a chunk of B
    frames — a single jitted program per chunk, keeping the device busy;
  * the only inherently *sequential* part — chaining relative poses into a
    global trajectory — is an ``associative_scan`` over 4×4 matmuls
    (O(log B) depth instead of O(B));
  * a failed pose (too few matches / degenerate geometry) contributes an
    identity relative transform, mirroring the reference's silent-return
    gates (``pose_estimator.cpp:22-26,44-47``) as masked no-ops so
    fixed-shape execution never breaks;
  * state carried between chunks: last frame's features + last global pose.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Iterator, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.common.camera import Camera
from tpuslam.config.schema import SlamConfig
from tpuslam.frontend.detector import FeatureDetector
from tpuslam.frontend.fast import KeypointSet
from tpuslam.frontend.matcher import match_descriptors
from tpuslam.frontend.pose import estimate_relative_pose


class VoState(NamedTuple):
    """Cross-chunk carry: previous frame's features and global pose."""

    prev_kps: KeypointSet
    prev_desc: jax.Array  # (K, B) uint8
    prev_exists: jax.Array  # () bool — false before the first frame
    pose: jax.Array  # (4, 4) float32 — T_world_cam of the last frame
    frame_idx: jax.Array  # () int32
    # Monocular scale propagation: depths (global scale) of the last frame's
    # keypoints from its pair triangulation, indexed by keypoint slot.
    prev_depth: jax.Array  # (K,) float32
    prev_depth_valid: jax.Array  # (K,) bool


class ChunkResult(NamedTuple):
    poses: jax.Array  # (B, 4, 4) — T_world_cam per frame in the chunk
    num_matches: jax.Array  # (B,) int32
    num_inliers: jax.Array  # (B,) int32
    pose_ok: jax.Array  # (B,) bool
    # Optional (populated when the chunk runs with_features=True, for the
    # full SLAM system: keyframing, loop closure, bundle adjustment).
    kps_xy: jax.Array | None = None  # (B, K, 2)
    kps_valid: jax.Array | None = None  # (B, K)
    desc: jax.Array | None = None  # (B, K, D) uint8
    m_query: jax.Array | None = None  # (B, M) int32 — into previous frame kps
    m_train: jax.Array | None = None  # (B, M) int32 — into current frame kps
    m_valid: jax.Array | None = None  # (B, M)
    points3d: jax.Array | None = None  # (B, M, 3) — current-camera coords
    point_ok: jax.Array | None = None  # (B, M)
    # PnP-tracking diagnostic: the costly RANSAC fallback cond was taken
    # (healthy frames descend from the motion prior — see model/tracking.py).
    pnp_used_ransac: jax.Array | None = None  # (B,)
    # PnP-tracking relocalization support: which frames solved an ABSOLUTE
    # pose against the map (self-anchored — a later rigid relocalization
    # correction must not touch them), and each frame's landmark-birth
    # watermark (so a correction re-anchors exactly the points that frame
    # and its chained successors inserted).
    pnp_absolute_ok: jax.Array | None = None  # (B,)
    pnp_point_count0: jax.Array | None = None  # (B,) int32
    # Per-frame landmark association (map slot + birth guard per keypoint)
    # — lets the loop-closure DB store multi-view landmark positions
    # instead of one-pair triangulations (see model/tracking.py).
    pnp_kp_to_point: jax.Array | None = None  # (B, K) int32
    pnp_kp_birth: jax.Array | None = None  # (B, K) int32


def _invert_rt(R: jax.Array, t: jax.Array) -> jax.Array:
    """[R|t] (cam2 ← cam1 coords) → 4×4 T_cam1_cam2."""
    Rt = jnp.swapaxes(R, -1, -2)
    top = jnp.concatenate([Rt, (-(Rt @ t[..., :, None]))], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), (*R.shape[:-2], 1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


class PnpState(NamedTuple):
    """Carry for PnP tracking mode: VO carry + persistent map + associations."""

    vo: "VoState"
    map: object  # MapState pytree
    assoc: object  # AssocState pytree


@dataclass
class SlamPipeline:
    """Batched monocular visual-odometry pipeline.

    ``tracking``: ``"vo"`` chains scaled two-view poses (unit baseline +
    depth-ratio scale propagation); ``"pnp"`` tracks each frame absolutely
    against the persistent landmark map via RANSAC DLT-PnP
    (:mod:`tpuslam.model.tracking` — BASELINE config 2, the reference's
    declared Map-centric design, ``include/slam/backend/map.hpp:9-21``).
    """

    camera: Camera
    config: SlamConfig
    tracking: str = "vo"
    map_window: int = 8
    max_map_points: int = 8192
    # Motion-model GN rounds in the per-frame PnP tracking scan (each
    # round lengthens its sequential spine; see model/tracking.py).
    # 3 rounds (16→8→2 px Huber anneal) measured behaviour-identical to 4
    # on the bench clip — same pose_ok/inlier/used_ransac/absolute_ok
    # stats to the frame — at one round less; the inlier-fraction/coverage
    # gates + RANSAC fallback bound the damage if a hard frame ever needs
    # the extra round (it then pays the cond, not accuracy).
    pnp_gn_iters: int = 3
    # Localization-only: the map is a loaded immutable reference (no
    # inserts) — see model/tracking.py freeze_map.
    freeze_map: bool = False

    def __post_init__(self) -> None:
        if self.tracking not in ("vo", "pnp"):
            raise ValueError(f"unknown tracking mode {self.tracking!r}")
        self.detector = FeatureDetector(self.config.detector)
        self._K = jnp.asarray(self.camera.K, dtype=jnp.float32)
        flat_idx, valid = self.camera.device_undistort_map()
        self._undistort_idx = flat_idx
        self._undistort_valid = valid
        self._chunk_fn = jax.jit(partial(self._process_chunk, with_features=False))
        self._chunk_full_fn = jax.jit(partial(self._process_chunk, with_features=True))
        self._sequence_fn = jax.jit(self.process_sequence)
        self._chunk_pnp_fn = jax.jit(self._process_chunk_pnp)
        self._chunk_pnp_full_fn = jax.jit(
            partial(self._process_chunk_pnp, with_features=True)
        )
        self._sequence_pnp_fn = jax.jit(self.process_sequence_pnp)

    # --- state ----------------------------------------------------------------
    def initial_state(self) -> VoState:
        k = self.config.detector.max_keypoints
        d = self.config.detector.descriptor_bytes
        empty_kps = KeypointSet(
            xy=jnp.zeros((k, 2), jnp.float32),
            response=jnp.zeros((k,), jnp.float32),
            angle=jnp.zeros((k,), jnp.float32),
            valid=jnp.zeros((k,), bool),
        )
        return VoState(
            prev_kps=empty_kps,
            prev_desc=jnp.zeros((k, d), jnp.uint8),
            prev_exists=jnp.asarray(False),
            pose=jnp.eye(4, dtype=jnp.float32),
            frame_idx=jnp.asarray(0, jnp.int32),
            prev_depth=jnp.zeros((k,), jnp.float32),
            prev_depth_valid=jnp.zeros((k,), bool),
        )

    # --- the jitted chunk program ----------------------------------------------
    def _frontend_batch(self, frames: jax.Array) -> tuple[KeypointSet, jax.Array]:
        from tpuslam.common.camera import undistort_image

        und = jax.vmap(
            lambda f: undistort_image(
                f, self._undistort_idx, self._undistort_valid, normalize=False
            )
        )(frames)
        # batch-native call (the fused Pallas path cannot be vmapped)
        return self.detector.detect_and_compute_batch(und)

    def _two_view_stage(
        self,
        frames: jax.Array,
        frame_valid: jax.Array,
        state: VoState,
        key: jax.Array,
    ):
        """Steps 1-6: the frame-parallel half shared by VO and PnP modes."""
        B = frames.shape[0]
        mcfg = self.config.matcher
        pcfg = self.config.pose

        # 1) frame-parallel frontend
        kps, desc = self._frontend_batch(frames)  # (B, K, ...), (B, K, D)

        # 2) consecutive pairs: (prev, f0), (f0, f1), ... (f_{B-2}, f_{B-1})
        kps_q = jax.tree.map(
            lambda prev, cur: jnp.concatenate([prev[None], cur[:-1]], axis=0),
            state.prev_kps,
            kps,
        )
        desc_q = jnp.concatenate([state.prev_desc[None], desc[:-1]], axis=0)
        # pair i is scorable iff both endpoints are real frames
        pair_ok = jnp.concatenate(
            [state.prev_exists[None], frame_valid[:-1]], axis=0
        ) & frame_valid

        # 3) frame-parallel matching (unfiltered: RANSAC wants all candidates)
        match = jax.vmap(
            lambda d1, d2, k1, k2: match_descriptors(
                d1,
                d2,
                k1.valid,
                k2.valid,
                k1.xy,
                k2.xy,
                ratio_threshold=mcfg.ratio_test_threshold,
                max_jump_radius=mcfg.max_jump_radius,
                use_ratio_test=mcfg.use_ratio_test,
                filter_matches=False,
                use_spatial_penalty=True,
            )
        )(desc_q, desc, kps_q, kps)

        # 4) gather matched pixel coordinates per pair
        def gather_pts(kq, kt, m):
            q = jnp.maximum(m.query_idx, 0)
            t = jnp.maximum(m.train_idx, 0)
            return kq.xy[q], kt.xy[t]

        pts1, pts2 = jax.vmap(gather_pts)(kps_q, kps, match)
        mvalid = match.valid & pair_ok[:, None]

        # 5) frame-parallel two-view RANSAC.  Keys are derived from the
        # GLOBAL frame index (fold_in), not the chunk-local split order, so
        # a resumed run reproduces the original key sequence regardless of
        # where chunk boundaries fall (checkpoint resume, utils/checkpoint).
        fids = state.frame_idx + jnp.arange(B, dtype=jnp.int32)
        keys = jax.vmap(lambda f: jax.random.fold_in(key, f))(fids)
        # In PnP mode the two-view solve only SEEDS the map-centric tracker
        # (motion_pnp + inlier/coverage gates + RANSAC-PnP fallback own the
        # pose), so it runs at the smaller SeedNumHypotheses budget — see
        # config.schema.PoseConfig.seed_num_hypotheses for the measurement.
        n_hyp = pcfg.num_hypotheses
        if self.tracking == "pnp" and pcfg.seed_num_hypotheses:
            n_hyp = min(pcfg.seed_num_hypotheses, pcfg.num_hypotheses)
        pose_fn = partial(
            estimate_relative_pose,
            num_hypotheses=n_hyp,
            sample_size=pcfg.sample_size,
            inlier_threshold_px=pcfg.inlier_threshold_px,
            min_matches=pcfg.min_matches,
        )
        res = jax.vmap(lambda p1, p2, v, k: pose_fn(p1, p2, v, self._K, k))(
            pts1, pts2, mvalid, keys
        )

        # 6) per-pair triangulation (in the pair's first-camera frame), both
        # for scale propagation and, with_features, for map points.
        from tpuslam.frontend.pose import triangulate_matched_points

        X_prev = jax.vmap(
            lambda R, t, p1, p2: triangulate_matched_points(self._K, R, t, p1, p2)
        )(res.R, res.t, pts1, pts2)  # (B, M, 3)
        X_cur = (
            jnp.einsum("bij,bmj->bmi", res.R, X_prev, precision="highest")
            + res.t[:, None, :]
        )
        z_prev = X_prev[..., 2]
        z_cur = X_cur[..., 2]
        mapc = self.config.map
        point_ok = (
            res.inliers
            & mvalid
            & (z_prev > mapc.min_triangulation_depth)
            & (z_prev < mapc.max_triangulation_depth)
            & (z_cur > mapc.min_triangulation_depth)
            & res.success[:, None]
        )
        return kps, desc, match, mvalid, res, pts1, pts2, X_prev, X_cur, point_ok

    def _process_chunk(
        self,
        frames: jax.Array,
        frame_valid: jax.Array,
        state: VoState,
        key: jax.Array,
        with_features: bool = False,
    ) -> tuple[ChunkResult, VoState]:
        B = frames.shape[0]
        (kps, desc, match, mvalid, res, pts1, pts2, X_prev, X_cur, point_ok) = (
            self._two_view_stage(frames, frame_valid, state, key)
        )
        z_prev = X_prev[..., 2]
        z_cur = X_cur[..., 2]

        # 7) monocular scale propagation.  Each two-view pose has unit
        # baseline; the true inter-frame scale is recovered from depths of
        # keypoints shared between consecutive pairs: pair i re-triangulates
        # (in its own unit) points pair i−1 saw, and the depth ratio is the
        # scale change.  All ratios are robust medians computed in parallel;
        # the cumulative product rescales each relative translation.
        K_cap = kps.valid.shape[1]
        q_idx = jnp.maximum(match.query_idx, 0)
        t_idx = jnp.maximum(match.train_idx, 0)
        # depths of frame i−1's keypoints as measured by pair i (raw units)
        d_query = jnp.zeros((B, K_cap)).at[
            jnp.arange(B)[:, None], jnp.where(point_ok, q_idx, K_cap)
        ].max(jnp.where(point_ok, z_prev, 0.0), mode="drop")
        # depths of frame i's keypoints as measured by pair i (raw units)
        d_cur = jnp.zeros((B, K_cap)).at[
            jnp.arange(B)[:, None], jnp.where(point_ok, t_idx, K_cap)
        ].max(jnp.where(point_ok, z_cur, 0.0), mode="drop")
        # reference depths for each pair's *query* frame: pair 0 compares
        # against the carried (global-scale) map, pair i against d_cur[i-1].
        d_ref = jnp.concatenate(
            [jnp.where(state.prev_depth_valid, state.prev_depth, 0.0)[None], d_cur[:-1]],
            axis=0,
        )
        common = (d_ref > 0) & (d_query > 0)
        ratio_kp = jnp.where(common, d_ref / jnp.maximum(d_query, 1e-9), jnp.nan)
        n_common = jnp.sum(common.astype(jnp.int32), axis=1)
        ratios = jnp.nanmedian(ratio_kp, axis=1)
        ratios = jnp.clip(jnp.nan_to_num(ratios, nan=1.0), 0.1, 10.0)
        ratios = jnp.where((n_common >= 10) & res.success, ratios, 1.0)
        cumscale = jnp.cumprod(ratios)  # (B,) global scale of each pair

        # 8) relative transforms with scaled baselines; failures → identity
        T_rel = _invert_rt(res.R, res.t * cumscale[:, None])  # T_prev_cur
        T_rel = jnp.where(res.success[:, None, None], T_rel, jnp.eye(4, dtype=T_rel.dtype))

        # 9) global poses via associative scan (O(log B) matmul chain)
        T_cum = jax.lax.associative_scan(jnp.matmul, T_rel)  # prefix products
        poses = state.pose[None] @ T_cum  # (B, 4, 4)

        # 10) new carry: last *valid* frame's features, pose, and depth map
        n_real = jnp.sum(frame_valid.astype(jnp.int32))
        last = jnp.maximum(n_real - 1, 0)
        new_kps = jax.tree.map(lambda a: a[last], kps)
        carry_depth = d_cur[last] * cumscale[last]
        new_state = VoState(
            prev_kps=new_kps,
            prev_desc=desc[last],
            prev_exists=state.prev_exists | (n_real > 0),
            pose=poses[last],
            frame_idx=state.frame_idx + n_real,
            prev_depth=jnp.where(res.success[last], carry_depth, state.prev_depth),
            prev_depth_valid=jnp.where(
                res.success[last], carry_depth > 0, state.prev_depth_valid
            ),
        )
        extra = {}
        if with_features:
            extra = dict(
                kps_xy=kps.xy,
                kps_valid=kps.valid,
                desc=desc,
                m_query=match.query_idx,
                m_train=match.train_idx,
                m_valid=mvalid,
                # map points in the current camera frame, global scale
                points3d=X_cur * cumscale[:, None, None],
                point_ok=point_ok,
            )
        result = ChunkResult(
            poses=poses,
            num_matches=jnp.sum(mvalid.astype(jnp.int32), axis=-1),
            num_inliers=res.num_inliers,
            pose_ok=res.success,
            **extra,
        )
        return result, new_state

    # --- PnP tracking mode (BASELINE config 2) ---------------------------------
    def initial_pnp_state(self) -> PnpState:
        from tpuslam.backend.map import empty_assoc, empty_map

        return PnpState(
            vo=self.initial_state(),
            map=empty_map(self.map_window, self.max_map_points),
            assoc=empty_assoc(self.config.detector.max_keypoints),
        )

    def _process_chunk_pnp(
        self,
        frames: jax.Array,
        frame_valid: jax.Array,
        state: PnpState,
        key: jax.Array,
        with_features: bool = False,
    ) -> tuple[ChunkResult, PnpState]:
        from tpuslam.model.tracking import pnp_track_chunk

        B = frames.shape[0]
        key_vo, key_pnp = jax.random.split(key)
        (kps, desc, match, mvalid, res, pts1, pts2, X_prev, X_cur, point_ok) = (
            self._two_view_stage(frames, frame_valid, state.vo, key_vo)
        )
        fids = state.vo.frame_idx + jnp.arange(B, dtype=jnp.int32)
        track, m_out, a_out, T_last = pnp_track_chunk(
            state.map,
            state.assoc,
            self._K,
            state.vo.pose,
            fids,
            frame_valid,
            jax.vmap(lambda f: jax.random.fold_in(key_pnp, f))(fids),
            res.R,
            res.t,
            res.success,
            kps.xy,
            match.query_idx,
            match.train_idx,
            mvalid,
            X_cur,
            X_prev[..., 2],
            point_ok,
            gate_px=self.config.map.assoc_gate_px,
            min_cand_depth=self.config.map.min_candidate_depth,
            gn_iters=self.pnp_gn_iters,
            freeze_map=self.freeze_map,
        )

        n_real = jnp.sum(frame_valid.astype(jnp.int32))
        last = jnp.maximum(n_real - 1, 0)
        new_vo = VoState(
            prev_kps=jax.tree.map(lambda a: a[last], kps),
            prev_desc=desc[last],
            prev_exists=state.vo.prev_exists | (n_real > 0),
            pose=track.poses[last],
            frame_idx=state.vo.frame_idx + n_real,
            prev_depth=state.vo.prev_depth,  # unused in PnP mode
            prev_depth_valid=state.vo.prev_depth_valid,
        )
        extra = {}
        if with_features:
            extra = dict(
                kps_xy=kps.xy,
                kps_valid=kps.valid,
                desc=desc,
                m_query=match.query_idx,
                m_train=match.train_idx,
                m_valid=mvalid,
                # current-camera coords at the metric baseline the tracker
                # actually applied to each pair (map-consistent scale)
                points3d=X_cur * track.scale[:, None, None],
                point_ok=point_ok,
            )
        result = ChunkResult(
            poses=track.poses,
            num_matches=jnp.sum(mvalid.astype(jnp.int32), axis=-1),
            num_inliers=jnp.where(
                track.pnp_ok, track.num_pnp_inliers, res.num_inliers
            ),
            pose_ok=track.pnp_ok | res.success,
            pnp_used_ransac=track.used_ransac,
            pnp_absolute_ok=track.pnp_ok,
            pnp_point_count0=track.point_count0,
            pnp_kp_to_point=track.kp_to_point,
            pnp_kp_birth=track.kp_birth,
            **extra,
        )
        return result, PnpState(vo=new_vo, map=m_out, assoc=a_out)

    def process_sequence_pnp(
        self,
        chunks: jax.Array,
        chunk_valid: jax.Array,
        state: PnpState,
        keys: jax.Array,
    ) -> tuple[ChunkResult, PnpState]:
        """One-dispatch scan of the PnP-tracking chunk program."""

        def step(st, xs):
            frames, valid, key = xs
            result, st = self._process_chunk_pnp(frames, valid, st, key)
            return st, result

        new_state, results = jax.lax.scan(step, state, (chunks, chunk_valid, keys))
        return results, new_state

    def run_pnp(
        self,
        frame_batches: Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]],
        seed: int = 0,
        initial_state: PnpState | None = None,
    ) -> dict:
        """PnP-tracking driver: ``FrameStream.batches()`` → trajectory + stats."""
        state = (
            initial_state if initial_state is not None else self.initial_pnp_state()
        )
        key = jax.random.PRNGKey(seed)
        poses: list[np.ndarray] = []
        stats = {"num_matches": [], "num_inliers": [], "pose_ok": []}
        from tpuslam.pre.stream import device_prefetch

        for frames, _stamps, valid in device_prefetch(frame_batches):
            result, state = self._chunk_pnp_fn(
                jnp.asarray(frames), jnp.asarray(valid), state, key
            )
            n = int(valid.sum())
            poses.append(np.asarray(result.poses)[:n])
            stats["num_matches"].append(np.asarray(result.num_matches)[:n])
            stats["num_inliers"].append(np.asarray(result.num_inliers)[:n])
            stats["pose_ok"].append(np.asarray(result.pose_ok)[:n])
        out = {
            "poses": np.concatenate(poses) if poses else np.zeros((0, 4, 4)),
            "map": state.map,
            "state": state,
        }
        for k in ("num_matches", "num_inliers", "pose_ok"):
            v = stats[k]
            out[k] = np.concatenate(v) if v else np.zeros((0,))
        return out

    # --- whole-sequence program: one dispatch, scan over chunks -----------------
    def process_sequence(
        self,
        chunks: jax.Array,  # (C, B, H, W) uint8
        chunk_valid: jax.Array,  # (C, B) bool
        state: VoState,
        keys: jax.Array,  # (C, 2) PRNG keys
    ) -> tuple[ChunkResult, VoState]:
        """Scan the chunk program over a whole sequence in one jitted call.

        Per-call dispatch latency adds up in chunked host loops; scanning on-device removes it.
        Results are stacked along the chunk axis.
        """

        def step(st, xs):
            frames, valid, key = xs
            result, st = self._process_chunk(frames, valid, st, key)
            return st, result

        new_state, results = jax.lax.scan(step, state, (chunks, chunk_valid, keys))
        return results, new_state

    # --- host driver -----------------------------------------------------------
    def run(
        self,
        frame_batches: Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]],
        seed: int = 0,
        initial_state: VoState | None = None,
    ) -> dict:
        """Consume ``FrameStream.batches()`` → trajectory + per-frame stats.

        Pass a checkpointed ``initial_state`` (and a stream started at
        ``state.frame_idx``) to resume: per-frame PRNG keys fold in the
        global frame index, so the resumed trajectory is bit-identical to
        an uninterrupted run with the same seed.  The final carry is
        returned under ``"state"`` for checkpointing.
        """
        state = initial_state if initial_state is not None else self.initial_state()
        key = jax.random.PRNGKey(seed)
        poses: list[np.ndarray] = []
        stats = {"num_matches": [], "num_inliers": [], "pose_ok": []}
        from tpuslam.pre.stream import device_prefetch

        for frames, _stamps, valid in device_prefetch(frame_batches):
            result, state = self._chunk_fn(
                jnp.asarray(frames), jnp.asarray(valid), state, key
            )
            n = int(valid.sum())
            poses.append(np.asarray(result.poses)[:n])
            stats["num_matches"].append(np.asarray(result.num_matches)[:n])
            stats["num_inliers"].append(np.asarray(result.num_inliers)[:n])
            stats["pose_ok"].append(np.asarray(result.pose_ok)[:n])
        return {
            "poses": np.concatenate(poses) if poses else np.zeros((0, 4, 4)),
            "state": state,
            **{k: np.concatenate(v) if v else np.zeros((0,)) for k, v in stats.items()},
        }
