"""SlamSystem: the complete SLAM stack — VO + keyframes + loop closure + BA.

This is the full composition the reference's ``SLAMModel`` declared but never
implemented (``model.hpp:20-27`` lists Camera → Preprocessor →
FeatureDetector → FeatureMatcher → PoseEstimator → Map → Backend →
Visualizer as commented-out members).  Concretely:

  * **tracking** — the batched VO pipeline (:mod:`tpuslam.model.slam`),
    which also triangulates per-pair map points on device;
  * **map** — the fixed-shape sliding window of
    :mod:`tpuslam.backend.map`, updated once per chunk
    (``update_map_chunk``): landmark identity is chained through every
    frame's match indices, so keyframes *re-observe* persistent landmarks
    and points accumulate multi-view observations — which is what makes
    windowed BA well-posed;
  * **backend** — sliding-window bundle adjustment
    (:mod:`tpuslam.backend.ba`) run every ``ba_interval`` keyframes, the
    functional equivalent of the reference's declared optimizer thread
    (``backend.hpp:13-17``): instead of a mutex-guarded shared map, the
    optimized window is folded back into the trajectory;
  * **loop closure** — BoW detection + PnP verification per keyframe
    (:mod:`tpuslam.backend.loop_closure`); detected loop constraints are
    folded back into the trajectory by pose-graph optimisation
    (:mod:`tpuslam.backend.pose_graph`) — capability the reference only
    gestured at (it computes LoopResult transforms and drops them).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.backend.ba import bundle_adjust
from tpuslam.backend.loop_closure import LoopClosure
from tpuslam.backend.map import (
    empty_assoc,
    empty_map,
    update_map_chunk,
    update_map_chunk_batched,
)
from tpuslam.backend.vocabulary import Vocabulary
from tpuslam.common.camera import Camera
from tpuslam.config.schema import SlamConfig
from tpuslam.model.slam import SlamPipeline


@jax.jit
def _map_points_per_keypoint(kps_valid, m_train, point_ok, points3d):
    """Scatter each frame's triangulations onto its keypoint slots.

    Returns ``(mp (B, K, 3), mp_valid (B, K))`` — the per-keypoint 3D points
    the loop-closure DB stores (keyframe camera frame), batched over the
    chunk (the round-1 code built these per keyframe on the host loop).
    """

    from tpuslam.backend.map import scatter_rows_dense

    def one(kv, t, ok, X):
        mp_rows, written = scatter_rows_dense(X, t, ok, kv.shape[0])
        return jnp.where(written[:, None], mp_rows, 0.0), written

    mp, mpv = jax.vmap(one)(kps_valid, m_train, point_ok, points3d)
    return mp, mpv


@dataclass
class SlamSystem:
    camera: Camera
    config: SlamConfig
    vocabulary: Vocabulary | str | Path | None = None
    # "vo" chains scaled two-view poses; "pnp" is the reference's declared
    # Map-centric architecture composed end-to-end: tracking consumes the
    # SAME persistent landmark map the backend optimises (``backend.hpp:
    # 13-17`` + mutex-shared ``Map``, ``map.hpp:9-21``) — BA's optimized
    # window folds straight back into the tracking carry.  In PnP mode
    # every valid frame is a keyframe (the map must stay current), so
    # ``keyframe_interval`` applies to VO mode only.
    tracking: str = "vo"
    keyframe_interval: int = 1
    ba_window: int = 8
    ba_interval: int = 4
    # 4 static LM steps: fixture window cost plateaus by step 4 (final BA
    # costs match the 5-step schedule to <1% on the out-and-back and
    # bench-clip windows), so a 5th step inside the sequence scan is
    # cost without gain.
    ba_iterations: int = 4
    # Compaction capacity for BA's LM loop (tpuslam.backend.ba): the
    # number of *observed* map points gathered into the dense Hessian
    # block.  A full 8-keyframe fixture window shows ~300 observed points;
    # 512 halves BA's Hessian block vs 1024 with ~1.7× headroom.  Overflow degrades gracefully —
    # lowest-priority points stay valid but unoptimised.
    ba_active_points: int = 512
    # Adaptive LM termination (see backend.ba.bundle_adjust): >0 stops
    # early once an accepted step improves the cost by <rtol relative.
    # Default 0: a `lax.while_loop` INSIDE the sequence scan costs more
    # than the iterations it saves (the same in-scan control-flow
    # pathology `_ba_cond` documents for `lax.cond`), so the
    # shipped default is a fixed 5-step `lax.scan`, where the fixtures'
    # cost has plateaued.  rtol>0 remains for host-driven BA calls
    # (checkpointed refinement, tools) where the loop is NOT inside a
    # sequence scan and early exit is real wall-clock.
    ba_rtol: float = 0.0
    # 4096 slots cover the 8-keyframe window with ~3× headroom (each frame
    # contributes ~150 gated points); BA cost scales linearly in capacity.
    max_map_points: int = 4096
    enable_loop_closure: bool = True
    enable_ba: bool = True
    enable_pose_graph: bool = True
    # VO-mode map fold: the chunk-batched rebuild (scan-oracle-equal,
    # tests/test_map_batched.py) instead of the per-frame scan whose
    # every-frame (W, P) observation-row rebuilds are mostly overwritten
    # within the same chunk.  False = the per-frame oracle.
    use_batched_map: bool = True
    # Global relocalization (both modes): frames that lose tracking query
    # the keyframe DB by BoW (no temporal gates) and, on geometric
    # verification, snap to an absolute pose anchored at the matched
    # keyframe's stored pose — the recovery path the reference's
    # architecture implies but never builds.  At most `reloc_budget` lost
    # frames per chunk verify (loss is rare; the budget keeps the chunk
    # program cheap); both modes pay nothing on healthy chunks (chunk-
    # level lax.cond).  PnP mode additionally re-anchors the landmarks
    # and keyframe-window rows its corrected frames inserted, and stops
    # the correction at the first later frame that re-solved an absolute
    # pose against the map — see `_reloc_chunk_pnp` for why that closes
    # the map-frame consistency question that round 3 left open.
    enable_relocalization: bool = True
    reloc_budget: int = 2
    # Localization-only mode (tracking="pnp"): track against a loaded,
    # FROZEN map+DB — no landmark/keyframe inserts, no BA, projection-
    # based data association (model/tracking.py freeze_map), and
    # relocalization allowed from frame 0 (the bootstrap: an unseen start
    # pose locks in by BoW against the loaded keyframe DB).  Pass the
    # loaded state via ``run_sequence(..., warm_start={"map":…, "db":…})``
    # (a previous run's checkpoint carries both).  Capability with no
    # reference counterpart — its architecture implies it (persistent
    # ``Map`` + keyframe DB) but nothing was ever built.
    localization_only: bool = False

    def __post_init__(self) -> None:
        if self.tracking not in ("vo", "pnp"):
            raise ValueError(f"unknown tracking mode {self.tracking!r}")
        if self.localization_only:
            if self.tracking != "pnp":
                raise ValueError(
                    "localization_only requires tracking='pnp' (the "
                    "map-centric tracker)"
                )
            self.enable_ba = False  # nothing to optimise on a frozen map
        self.pipeline = SlamPipeline(
            self.camera,
            self.config,
            tracking=self.tracking,
            map_window=self.ba_window,
            max_map_points=self.max_map_points,
            freeze_map=self.localization_only,
        )
        self._K = jnp.asarray(self.camera.K, jnp.float32)
        self.loop_closure = None
        if self.enable_loop_closure and self.vocabulary is not None:
            self.loop_closure = LoopClosure(
                self.vocabulary, self.config.loop_closure, self.config.matcher
            )
        self._sequence_jit = jax.jit(self._sequence_impl)
        # jitted for the streaming run() host loop (the sequence scan
        # inlines _reloc_chunk / _reloc_chunk_pnp directly)
        self._reloc_chunk_jit = jax.jit(self._reloc_chunk)
        self._reloc_chunk_pnp_jit = jax.jit(self._reloc_chunk_pnp)
        self._lc_chunk_jit = jax.jit(self._lc_chunk, static_argnames=("B",))

    # --- shared backend stages --------------------------------------------------
    def _lc_chunk(self, db, fids, kf_enabled, result, key2, B, m=None):
        if m is not None and result.pnp_kp_to_point is not None:
            # PnP mode: the DB stores each keyframe's MAP LANDMARK
            # positions (multi-view, BA-refined, world → that frame's
            # camera).  One-pair triangulated depths carry enough noise to
            # break relocalization's depth-ratio scale (measured:
            # stored/unit ratios spread 1.0-4.2 on one keyframe, snapping
            # a relocalized frame 1.8 units short); landmark depths are
            # the reference's actual intent for ``KeyframeData::mapPoints``
            # (``loop_closure.cpp:96-109``).  No pair-triangulation
            # fallback: every keypoint the pair path would cover is also
            # associated (new points get their slot at insert — measured
            # pair-only coverage 0 on every fixture frame), so the vmapped
            # per-keypoint scatter is pure cost here.
            slot = jnp.maximum(result.pnp_kp_to_point, 0)  # (B, K)
            okp = (
                (result.pnp_kp_to_point >= 0)
                & (m.point_birth[slot] == result.pnp_kp_birth)
                & m.point_valid[slot]
                & result.kps_valid
            )
            X = m.points[slot]  # (B, K, 3) world
            R_cw = jnp.swapaxes(result.poses[:, :3, :3], -1, -2)  # (B,3,3)
            C = result.poses[:, :3, 3]  # (B, 3)
            Xc = jnp.einsum("bij,bkj->bki", R_cw, X - C[:, None, :])
            mp = jnp.where(okp[..., None], Xc, 0.0)
            mpv = okp
        else:
            mp, mpv = _map_points_per_keypoint(
                result.kps_valid, result.m_train, result.point_ok,
                result.points3d,
            )
        return self.loop_closure._process_chunk_impl(
            db, fids, kf_enabled, result.desc, result.kps_xy,
            result.kps_valid, mp, mpv, self._K, jax.random.split(key2, B),
            poses=result.poses,
        )

    def _ba_cond(self, m, since_ba):
        """Windowed BA when the keyframe counter reaches the interval;
        returns (map, initial_cost, final_cost, ran).

        When the interval is ≤ the per-chunk keyframe count (statically
        known), BA fires every chunk anyway — run it unconditionally and
        select.  ``lax.cond`` inside the sequence ``scan`` can cost far
        more than its branch (the *taken* branch at 0 LM iterations cost
        many times the identical standalone program); the branchless select
        sidesteps it entirely.  The cond path remains for
        genuinely sparse BA schedules, where skipped chunks must not pay.
        """
        due = since_ba >= self.ba_interval
        kf_per_chunk = max(
            self.config.batch_size // max(self.keyframe_interval, 1), 1
        )
        if self.tracking == "pnp":
            kf_per_chunk = self.config.batch_size
        if self.ba_interval <= kf_per_chunk:
            ba = bundle_adjust(
                m, self._K, iterations=self.ba_iterations,
                active_points=self.ba_active_points, rtol=self.ba_rtol,
            )
            m2 = jax.tree.map(
                lambda new, old: jnp.where(due, new, old), ba.map, m
            )
            return (
                m2,
                jnp.where(due, ba.initial_cost, 0.0),
                jnp.where(due, ba.final_cost, 0.0),
                due,
            )

        def do_ba(m_in):
            ba = bundle_adjust(
                m_in, self._K, iterations=self.ba_iterations,
                active_points=self.ba_active_points, rtol=self.ba_rtol,
            )
            return ba.map, ba.initial_cost, ba.final_cost, jnp.asarray(True)

        def no_ba(m_in):
            return m_in, jnp.float32(0), jnp.float32(0), jnp.asarray(False)

        return jax.lax.cond(since_ba >= self.ba_interval, do_ba, no_ba, m)

    def _reloc_chunk_pnp(self, db, result, m, valid, fids, key):
        """Relocalize lost frames of a PnP chunk; re-anchor the map too.

        The map-frame consistency question (round-3's stated reason PnP
        mode had no relocalization): map inserts happen INSIDE the
        tracking scan, so a post-hoc pose snap must also correct the
        landmarks/keyframes that the corrected frames inserted, or the
        trajectory and the map split into two world frames.  Three facts
        make the exact fix cheap:

        * a frame whose trackers BOTH fail inserts nothing (``enabled``
          gates inserts on ``pnp_ok | vok``), so a genuinely blind span
          never pollutes the map;
        * a frame that later re-solves an ABSOLUTE pose against the
          persistent map (``pnp_absolute_ok``) is self-anchored: the
          rigid correction must stop there (unlike VO mode, where every
          pose is chained and the last-snap-wins prefix runs to the
          chunk end);
        * the landmarks each frame inserted are exactly those with
          ``point_birth >= point_count0[f]`` (birth counters are
          monotone), so per-point corrections are a comparison + gather,
          and keyframe-window rows map back to frames by ``kf_id``.

        Correction per frame f: the LATEST event at-or-before f wins —
        a reloc snap applies ``M = T_reloc·T_f⁻¹``; an absolute-PnP
        anchor resets to identity.  World-frame update X' = M X ⇒
        keyframe (R, t) → (R·M_Rᵀ, t − R·M_Rᵀ·M_t).  Only poses, flags,
        the (P, 3) point buffer and the (W, 3, 3) keyframe rows cross the
        cond boundary (the ``_ba_cond`` pathology concerns far larger
        carried state).
        """
        B = result.poses.shape[0]
        need = valid & ~result.pose_ok
        if not self.localization_only:
            # Frame 0 of a fresh mapping run has an empty DB; in
            # localization mode the loaded DB is exactly what frame 0
            # must bootstrap against.
            need = need & (fids > 0)
        eyeB = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))

        def do_reloc(_):
            r_ok, T_reloc, _, _ = self.loop_closure._relocalize_impl(
                db, need, result.desc, result.kps_xy, result.kps_valid,
                self._K, jax.random.split(key, B), budget=self.reloc_budget,
            )
            R = result.poses[:, :3, :3]
            t = result.poses[:, :3, 3]
            Rt = jnp.swapaxes(R, -1, -2)
            P_inv = (
                eyeB.at[:, :3, :3].set(Rt)
                .at[:, :3, 3].set(-jnp.einsum("bij,bj->bi", Rt, t))
            )
            Msnap = T_reloc @ P_inv
            tri = jnp.arange(B)
            last_snap = jax.lax.associative_scan(
                jnp.maximum, jnp.where(r_ok, tri, -1)
            )
            last_anchor = jax.lax.associative_scan(
                jnp.maximum, jnp.where(result.pnp_absolute_ok, tri, -1)
            )
            live = (last_snap >= 0) & (last_snap > last_anchor)
            M = jnp.where(
                live[:, None, None], Msnap[jnp.clip(last_snap, 0)], eyeB
            )

            if self.localization_only:
                # The loaded map is immutable (nothing was inserted, and
                # its kf_id values are OLD frame ids that may collide with
                # the current fid range) — corrections touch poses only.
                points2, kf_R2, kf_t2 = m.points, m.kf_R, m.kf_t
            else:
                # --- re-anchor landmarks born at corrected frames ---------
                birth = m.point_birth  # (P,)
                count0 = result.pnp_point_count0  # (B,)
                fidx = (
                    jnp.sum(
                        (birth[:, None] >= count0[None, :]).astype(jnp.int32),
                        axis=1,
                    )
                    - 1
                )  # (P,) owning frame, −1 = born before this chunk
                Mp = M[jnp.clip(fidx, 0, B - 1)]  # (P, 4, 4)
                corr_pt = (fidx >= 0) & m.point_valid
                pts = (
                    jnp.einsum("pij,pj->pi", Mp[:, :3, :3], m.points)
                    + Mp[:, :3, 3]
                )
                points2 = jnp.where(corr_pt[:, None], pts, m.points)

                # --- re-anchor keyframe-window rows inserted this chunk ---
                kidx = m.kf_id - fids[0]  # (W,)
                in_chunk = (kidx >= 0) & (kidx < B) & m.kf_valid
                Mk = M[jnp.clip(kidx, 0, B - 1)]  # (W, 4, 4)
                MkRT = jnp.swapaxes(Mk[:, :3, :3], -1, -2)
                R2 = jnp.matmul(m.kf_R, MkRT, precision="highest")
                t2 = m.kf_t - jnp.einsum("wij,wj->wi", R2, Mk[:, :3, 3])
                kf_R2 = jnp.where(in_chunk[:, None, None], R2, m.kf_R)
                kf_t2 = jnp.where(in_chunk[:, None], t2, m.kf_t)

            return (
                M @ result.poses,
                result.pose_ok | r_ok,
                points2,
                kf_R2,
                kf_t2,
                M[-1],
                r_ok,
            )

        def skip(_):
            return (
                result.poses, result.pose_ok, m.points, m.kf_R, m.kf_t,
                jnp.eye(4, dtype=jnp.float32), jnp.zeros(B, bool),
            )

        poses, pose_ok, points2, kf_R2, kf_t2, M_last, r_ok = jax.lax.cond(
            jnp.any(need), do_reloc, skip, None
        )
        m2 = m._replace(points=points2, kf_R=kf_R2, kf_t=kf_t2)
        return (
            result._replace(poses=poses, pose_ok=pose_ok), m2, M_last, r_ok
        )

    def _reloc_chunk(self, db, result, valid, fids, key):
        """Relocalize lost frames of a VO chunk; fold rescues back in.

        Returns ``(result', M_last)``: the chunk result with corrected
        poses / pose_ok, and the rigid correction carried past the chunk
        end (to re-anchor the cross-chunk chain pose).  An absolute snap at
        frame i overrides every earlier correction (M_i = T_reloc_i·T_i⁻¹
        regardless of prior M — the algebra collapses), so the per-frame
        correction is a last-snap-wins prefix maximum, not a product chain.
        """
        B = result.poses.shape[0]
        need = valid & ~result.pose_ok & (fids > 0)
        eyeB = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))

        def do_reloc(_):
            r_ok, T_reloc, _, _ = self.loop_closure._relocalize_impl(
                db, need, result.desc, result.kps_xy, result.kps_valid,
                self._K, jax.random.split(key, B), budget=self.reloc_budget,
            )
            R = result.poses[:, :3, :3]
            t = result.poses[:, :3, 3]
            Rt = jnp.swapaxes(R, -1, -2)
            P_inv = (
                eyeB.at[:, :3, :3].set(Rt)
                .at[:, :3, 3].set(-jnp.einsum("bij,bj->bi", Rt, t))
            )
            Msnap = T_reloc @ P_inv
            tri = jnp.arange(B)
            last = jax.lax.associative_scan(
                jnp.maximum, jnp.where(r_ok, tri, -1)
            )
            M = jnp.where(
                (last >= 0)[:, None, None], Msnap[jnp.clip(last, 0)], eyeB
            )
            return M @ result.poses, result.pose_ok | r_ok, M[-1], r_ok

        def skip(_):
            return (
                result.poses, result.pose_ok,
                jnp.eye(4, dtype=jnp.float32), jnp.zeros(B, bool),
            )

        # Lost frames are rare: in steady state every chunk tracks, so the
        # expensive part (BoW transform + budget× two-view verification)
        # must not be paid unconditionally.  A real XLA conditional makes
        # relocalization free until a frame actually loses tracking (the
        # branchless version paid it on every chunk, for a stage that
        # fires on 0% of healthy chunks).
        # Only small arrays (poses, flags) cross the conditional boundary:
        # `_ba_cond` documents a severe cost for conds inside the sequence
        # scan when large carried state flows through them, so the big
        # ChunkResult buffers stay outside.  Under vmap (multiseq mode)
        # the cond lowers to a select and both branches run — correct,
        # just not faster; the single-sequence scan is what needs it.
        poses, pose_ok, M_last, r_ok = jax.lax.cond(
            jnp.any(need), do_reloc, skip, None
        )
        return result._replace(poses=poses, pose_ok=pose_ok), M_last, r_ok

    def _warm_start_map(self, m):
        """Prepare a loaded map for reuse in a NEW run starting at frame 0.

        The loaded keyframe-window rows carry ``kf_id`` frame ids from the
        run that built them; the new run re-issues those same ids, and two
        consumers infer "inserted this run" from frame-id arithmetic:
        ``_reloc_chunk_pnp`` (``kidx = kf_id - fids[0]`` picks rows to
        rigid-correct) and ``_apply_ba_snapshot`` (``kf_id`` indexes the
        trajectory).  A collision rigid-corrects or overwrites poses of
        unrelated frames.  Re-stamp loaded rows to strictly negative ids
        (order-preserving shift below the invalid sentinel −1): negative
        ids are outside every ``[fids[0], fids[0]+B)`` window and outside
        ``[0, n)`` trajectory indexing, so loaded rows stay BA-optimisable
        but are never mistaken for this-run insertions.  Localization-only
        mode keeps the map frozen and documents the same collision;
        mapping-mode reuse needs this re-stamp.
        """
        if self.localization_only:
            return m
        max_id = jnp.max(jnp.where(m.kf_valid, m.kf_id, jnp.int32(-1)))
        shifted = m.kf_id - (max_id + 2)  # valid rows end ≤ −2
        return m._replace(
            kf_id=jnp.where(m.kf_valid, shifted, m.kf_id)
        )

    @staticmethod
    def _refreshed_pose(m, ran, fallback_pose):
        """T_world_cam of the newest keyframe in the (BA-optimised) window.

        This is what closes the reference's shared-Map loop: after the
        backend optimises, the tracker's chain pose continues from the
        *optimised* newest keyframe instead of the raw one.
        """
        slot = (m.kf_count - 1) % m.window
        R_cw = m.kf_R[slot]
        C = -jnp.einsum("ji,j->i", R_cw, m.kf_t[slot], precision="highest")
        top = jnp.concatenate([R_cw.T, C[:, None]], axis=1)
        T_opt = jnp.concatenate(
            [top, jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32)], axis=0
        )
        return jnp.where(ran & m.kf_valid[slot], T_opt, fallback_pose)

    # --- one-dispatch sequence program -----------------------------------------
    def _sequence_impl(self, chunks, chunk_valid, carry0, keys):
        """Scan the FULL SLAM chunk — tracking, map, loop closure, BA — over
        a staged sequence in one jitted dispatch.

        Scanning on-device removes per-chunk dispatch, transfer hand-offs
        and host bookkeeping from the steady state.  BA runs under
        ``lax.cond`` when the carried keyframe counter reaches
        ``ba_interval``; its window snapshot is emitted per chunk for the
        host to fold into the trajectory afterwards.
        """
        lc = self.loop_closure
        K = self._K
        kfi = self.keyframe_interval
        pnp_mode = self.tracking == "pnp"

        def step(carry, xs):
            frames, valid, key = xs
            key1, key2 = jax.random.split(key)
            B = frames.shape[0]
            if pnp_mode:
                st, db, since_ba = carry
                fids = st.vo.frame_idx + jnp.arange(B, dtype=jnp.int32)
                result, st2 = self.pipeline._process_chunk_pnp(
                    frames, valid, st, key1, with_features=True
                )
                reloc_ok = jnp.zeros(B, bool)
                if lc is not None and self.enable_relocalization:
                    result, m_fix, M_last, reloc_ok = self._reloc_chunk_pnp(
                        db, result, st2.map, valid, fids,
                        jax.random.fold_in(key2, 777),
                    )
                    st2 = st2._replace(
                        map=m_fix,
                        vo=st2.vo._replace(pose=M_last @ st2.vo.pose),
                    )
                # every valid tracked frame is a keyframe in PnP mode
                # (kf_enabled AFTER relocalization: rescued frames insert
                # their corrected poses into the DB); localization mode
                # never inserts — the loaded DB is the frozen reference
                if self.localization_only:
                    kf_enabled = jnp.zeros(B, bool)
                else:
                    kf_enabled = valid & (result.pose_ok | (fids == 0))
                m2 = st2.map
            else:
                vo, m, a, db, since_ba = carry
                fids = vo.frame_idx + jnp.arange(B, dtype=jnp.int32)
                result, vo2 = self.pipeline._process_chunk(
                    frames, valid, vo, key1, with_features=True
                )
                reloc_ok = jnp.zeros(B, bool)
                if lc is not None and self.enable_relocalization:
                    result, M_last, reloc_ok = self._reloc_chunk(
                        db, result, valid, fids,
                        jax.random.fold_in(key2, 777),
                    )
                    vo2 = vo2._replace(pose=M_last @ vo2.pose)
                kf_mask = ((fids % kfi) == 0) & valid
                map_fold = (
                    update_map_chunk_batched
                    if self.use_batched_map
                    else update_map_chunk
                )
                m2, a2 = map_fold(
                    m, a, K, fids, kf_mask, result.poses, result.pose_ok,
                    result.kps_xy, result.m_query, result.m_train,
                    result.m_valid, result.points3d, result.point_ok,
                    gate_px=self.config.map.assoc_gate_px,
                    min_cand_depth=self.config.map.min_candidate_depth,
                )
                kf_enabled = kf_mask & (result.pose_ok | (fids == 0))
            out = {
                "poses": result.poses,
                "pose_ok": result.pose_ok,
                "num_matches": result.num_matches,
                "num_inliers": result.num_inliers,
                "kf_enabled": kf_enabled,
                "reloc_ok": reloc_ok,
            }
            if lc is not None:
                db, out["loop"] = self._lc_chunk(
                    db, fids, kf_enabled, result, key2, B,
                    m=m2 if pnp_mode else None,
                )
            since_ba = since_ba + jnp.sum(kf_enabled.astype(jnp.int32))
            if self.enable_ba:
                m2, c0, c1, ran = self._ba_cond(m2, since_ba)
                since_ba = jnp.where(ran, 0, since_ba)
                out["ba_ran"] = ran
                out["ba_costs"] = jnp.stack([c0, c1])
                out["ba_kf_id"] = m2.kf_id
                out["ba_kf_valid"] = m2.kf_valid & ran
                out["ba_kf_R"] = m2.kf_R
                out["ba_kf_t"] = m2.kf_t
            if pnp_mode:
                # Shared-Map feedback: the optimised window *is* the map the
                # next chunk tracks against, and the chain pose continues
                # from the optimised newest keyframe.
                if self.enable_ba:
                    pose2 = self._refreshed_pose(m2, ran, st2.vo.pose)
                    st2 = st2._replace(
                        map=m2, vo=st2.vo._replace(pose=pose2)
                    )
                return (st2, db, since_ba), out
            return (vo2, m2, a2, db, since_ba), out

        carry, outs = jax.lax.scan(step, carry0, (chunks, chunk_valid, keys))
        return carry, outs

    def run_sequence(
        self,
        frames: np.ndarray,
        seed: int = 0,
        warm_start: dict | None = None,
    ) -> dict:
        """One-dispatch SLAM over a pre-staged (N, H, W) frame array.

        The throughput path (``bench.py --slam``): frames are transferred
        once, the whole sequence executes as a single device program, and
        results convert to host once.  ``run()`` remains the streaming
        driver for unbounded sequences.

        ``warm_start``: optional ``{"map": MapState, "db": KeyframeDB}``
        to start from prebuilt state (e.g. a previous run's checkpoint) —
        required input for ``localization_only`` mode, useful for
        map-reuse in general.
        """
        B = self.config.batch_size
        n = len(frames)
        n_chunks = -(-n // B)
        pad = n_chunks * B - n
        if pad:
            frames = np.concatenate([np.asarray(frames), np.repeat(np.asarray(frames[-1:]), pad, 0)])
        valid = (np.arange(n_chunks * B) < n).reshape(n_chunks, B)
        chunks = jnp.asarray(frames.reshape(n_chunks, B, *frames.shape[1:]))
        base = jax.random.PRNGKey(seed)
        keys = jax.vmap(lambda c: jax.random.fold_in(base, c))(
            jnp.arange(n_chunks, dtype=jnp.int32)
        )

        db = (
            self.loop_closure.new_db(
                self.config.detector.max_keypoints,
                self.config.detector.descriptor_bytes,
            )
            if self.loop_closure is not None
            else jnp.zeros(())
        )
        if warm_start is not None and "db" in warm_start:
            db = warm_start["db"]
        if self.localization_only and (
            warm_start is None or "map" not in warm_start
        ):
            raise ValueError(
                "localization_only needs warm_start={'map':…, 'db':…} "
                "(a previous run's checkpoint carries both)"
            )
        if self.tracking == "pnp":
            st0 = self.pipeline.initial_pnp_state()
            if warm_start is not None and "map" in warm_start:
                st0 = st0._replace(
                    map=self._warm_start_map(warm_start["map"])
                )
            carry0 = (
                st0,
                db,
                jnp.asarray(0, jnp.int32),
            )
        else:
            carry0 = (
                self.pipeline.initial_state(),
                self._warm_start_map(warm_start["map"])
                if warm_start and "map" in warm_start
                else empty_map(self.ba_window, self.max_map_points),
                empty_assoc(self.config.detector.max_keypoints),
                db,
                jnp.asarray(0, jnp.int32),
            )
        carry, outs = self._sequence_jit(
            chunks, jnp.asarray(valid), carry0, keys
        )
        jax.block_until_ready(outs["poses"])

        # ---- host-side conversion + folding (once) -------------------------
        poses = np.array(outs["poses"]).reshape(-1, 4, 4)[:n]
        pose_ok = np.asarray(outs["pose_ok"]).reshape(-1)[:n]
        kf_enabled = np.asarray(outs["kf_enabled"]).reshape(-1)[:n]
        kf_fids = [int(f) for f in np.nonzero(kf_enabled)[0]]
        loops: list[dict] = []
        if "loop" in outs:
            lres = outs["loop"]
            succ = np.asarray(lres.success).reshape(-1)[:n]
            matched = np.asarray(lres.matched_keyframe_id).reshape(-1)[:n]
            n_inl = np.asarray(lres.num_inliers).reshape(-1)[:n]
            T_rel = np.asarray(lres.relative_transform).reshape(-1, 4, 4)[:n]
            for f in np.nonzero(succ)[0]:
                loops.append(
                    {
                        "frame_id": int(f),
                        "matched_keyframe_id": int(matched[f]),
                        "num_inliers": int(n_inl[f]),
                        "relative_transform": T_rel[f],
                    }
                )
        ba_events: list[dict] = []
        if self.enable_ba:
            ran = np.asarray(outs["ba_ran"])
            costs = np.asarray(outs["ba_costs"])
            for c in np.nonzero(ran)[0]:
                snapshot = {
                    "kf_id": np.asarray(outs["ba_kf_id"][c]),
                    "kf_valid": np.asarray(outs["ba_kf_valid"][c]),
                    "kf_R": np.asarray(outs["ba_kf_R"][c]),
                    "kf_t": np.asarray(outs["ba_kf_t"][c]),
                }
                ba_events.append(
                    {
                        "frame_id": int(min((c + 1) * B, n) - 1),
                        "initial_cost": float(costs[c, 0]),
                        "final_cost": float(costs[c, 1]),
                    }
                )
                poses = self._apply_ba_snapshot(snapshot, poses)

        pose_graph_applied = False
        if self.enable_pose_graph and loops and len(kf_fids) >= 2:
            poses = self._apply_pose_graph(poses, kf_fids, loops)
            pose_graph_applied = True
        return {
            "poses": poses,
            "loops": loops,
            "ba_events": ba_events,
            "map": carry[0].map if self.tracking == "pnp" else carry[1],
            "db": carry[1] if self.tracking == "pnp" else carry[3],
            "pose_graph_applied": pose_graph_applied,
            "num_matches": np.asarray(outs["num_matches"]).reshape(-1)[:n],
            "num_inliers": np.asarray(outs["num_inliers"]).reshape(-1)[:n],
            "pose_ok": pose_ok,
            "reloc_ok": (
                np.asarray(outs["reloc_ok"]).reshape(-1)[:n]
                if "reloc_ok" in outs
                else np.zeros(n, bool)
            ),
        }

    def checkpoint_template(self) -> dict:
        """Structure template for :func:`tpuslam.utils.checkpoint.load_state`.

        Array shapes are placeholders — only the tree structure matters for
        deserialisation (saved shapes come from the .npz itself).
        """
        if self.tracking == "pnp":
            state = self.pipeline.initial_pnp_state()
        else:
            state = self.pipeline.initial_state()
        db = (
            self.loop_closure.new_db(
                self.config.detector.max_keypoints,
                self.config.detector.descriptor_bytes,
            )
            if self.loop_closure is not None
            else jnp.zeros(())
        )
        z = np.zeros
        return {
            "carry_state": state,
            "world_map": empty_map(self.ba_window, self.max_map_points),
            "assoc": empty_assoc(self.config.detector.max_keypoints),
            "db": db,
            "counters": z(3, np.int64),
            "raw_poses": z((0, 4, 4), np.float32),
            "stats_matches": z(0, np.int32),
            "stats_inliers": z(0, np.int32),
            "stats_pose_ok": z(0, bool),
            "stats_reloc_ok": z(0, bool),
            "kf_fids": z(0, np.int32),
            "loops_frame": z(0, np.int32),
            "loops_matched": z(0, np.int32),
            "loops_ninl": z(0, np.int32),
            "loops_T": z((0, 4, 4), np.float32),
            "ba_frame": z(0, np.int32),
            "ba_costs": z((0, 2), np.float32),
            "ba_kf_id": z((0, self.ba_window), np.int32),
            "ba_kf_valid": z((0, self.ba_window), bool),
            "ba_kf_R": z((0, self.ba_window, 3, 3), np.float32),
            "ba_kf_t": z((0, self.ba_window, 3), np.float32),
        }

    def run(
        self,
        frame_batches: Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]],
        seed: int = 0,
        resume: dict | None = None,
        warm_start: dict | None = None,
    ) -> dict:
        """Stream frames through tracking + map + loop closure + BA.

        The chunk loop never blocks on the device: every per-chunk product
        (poses, stats, stacked loop results, BA cost/pose snapshots) is kept
        as device arrays and converted once after the last chunk, so
        dispatches pipeline back-to-back (the round-1 loop synced per
        keyframe).  BA is scheduled on
        the *expected* keyframe count (pose failures are rare and only shift
        the schedule by one chunk); its optimized keyframe poses are folded
        into the trajectory in event order at the end, which commutes with
        the incremental folding it replaces.

        ``resume``: a ``result["checkpoint"]`` payload from a previous run
        (deserialised against :meth:`checkpoint_template`).  The stream must
        continue at the saved frame counter (``counters[0]``) with the same
        batch size; keys are chunk-indexed, BA/pose-graph folding is
        deferred to the end of the *final* segment, and the saved raw
        trajectory/loop/BA state is prepended — so a split run reproduces
        the uninterrupted run exactly.

        ``warm_start``: ``{"map": MapState, "db": KeyframeDB}`` to start a
        NEW stream (frame ids from 0) against prebuilt state — the
        streaming counterpart of :meth:`run_sequence`'s ``warm_start``,
        and the REQUIRED input for ``localization_only`` mode, whose whole
        story is unbounded deployment against a frozen map: this path
        holds one chunk of frames at a time (flat host RSS), unlike the
        staged ``run_sequence``.  Mutually exclusive with ``resume``
        (which restores its own map/DB and frame counter).
        """
        pnp_mode = self.tracking == "pnp"
        if resume is not None and warm_start is not None:
            raise ValueError(
                "resume and warm_start are mutually exclusive (a resume "
                "payload already carries its own map/DB state)"
            )
        if self.localization_only and resume is None and (
            warm_start is None or "map" not in warm_start
        ):
            raise ValueError(
                "localization_only needs warm_start={'map':…, 'db':…} "
                "(a previous run's checkpoint carries both)"
            )
        if resume is not None:
            state = resume["carry_state"]
            world_map = resume["world_map"]
            assoc = resume["assoc"]
            db = resume["db"] if self.loop_closure is not None else None
            frame_id, chunk_idx, kf_expected_since_ba = (
                int(x) for x in np.asarray(resume["counters"])
            )
        else:
            if pnp_mode:
                state = self.pipeline.initial_pnp_state()
            else:
                state = self.pipeline.initial_state()
            world_map = empty_map(self.ba_window, self.max_map_points)
            assoc = empty_assoc(self.config.detector.max_keypoints)
            db = (
                self.loop_closure.new_db(
                    self.config.detector.max_keypoints,
                    self.config.detector.descriptor_bytes,
                )
                if self.loop_closure is not None
                else None
            )
            if warm_start is not None:
                if "db" in warm_start and db is not None:
                    db = warm_start["db"]
                if "map" in warm_start:
                    world_map = self._warm_start_map(warm_start["map"])
                    if pnp_mode:
                        state = state._replace(map=world_map)
            frame_id = 0
            kf_expected_since_ba = 0
            chunk_idx = 0
        key = jax.random.PRNGKey(seed)

        records: list[dict] = []

        from tpuslam.pre.stream import device_prefetch

        for frames, _stamps, valid in device_prefetch(frame_batches):
            # chunk-indexed keys match run_sequence() exactly (tested)
            k_chunk = jax.random.fold_in(key, chunk_idx)
            chunk_idx += 1
            sub, sub_lc = jax.random.split(k_chunk)
            chunk_fn = (
                self.pipeline._chunk_pnp_full_fn
                if pnp_mode
                else self.pipeline._chunk_full_fn
            )
            result, state = chunk_fn(
                jnp.asarray(frames), jnp.asarray(valid), state, sub
            )
            n = int(valid.sum())
            B = result.poses.shape[0]
            fids_full = np.arange(frame_id, frame_id + B, dtype=np.int32)
            if (
                self.loop_closure is not None
                and db is not None
                and self.enable_relocalization
                # host gate: relocalizing nothing yields identity
                # corrections, so skipping when no frame is lost is
                # outcome-identical and saves the verification programs
                # (the one-dispatch scan path stays branchless instead).
                # Mirrors the `need` computation in _reloc_chunk[_pnp]:
                # localization-only mode must bootstrap at frame 0
                # against the loaded DB, so the fids>0 term drops there.
                and bool(
                    (
                        ~np.asarray(result.pose_ok)
                        & np.asarray(valid)
                        & (
                            np.ones_like(fids_full, bool)
                            if self.localization_only
                            else fids_full > 0
                        )
                    ).any()
                )
            ):
                # identical key derivation to _sequence_impl (split-run ==
                # single-run equality depends on it)
                if pnp_mode:
                    result, m_fix, M_last, reloc_ok = self._reloc_chunk_pnp_jit(
                        db, result, state.map, jnp.asarray(valid),
                        jnp.asarray(fids_full),
                        jax.random.fold_in(sub_lc, 777),
                    )
                    state = state._replace(
                        map=m_fix,
                        vo=state.vo._replace(pose=M_last @ state.vo.pose),
                    )
                else:
                    result, M_last, reloc_ok = self._reloc_chunk_jit(
                        db, result, jnp.asarray(valid),
                        jnp.asarray(fids_full), jax.random.fold_in(sub_lc, 777),
                    )
                    state = state._replace(pose=M_last @ state.pose)
            else:
                reloc_ok = jnp.zeros(B, bool)
            if pnp_mode:
                if self.localization_only:
                    # frozen map/DB: nothing is ever inserted (mirrors the
                    # kf_enabled = zeros branch of _sequence_impl)
                    kf_mask = np.zeros(B, bool)
                else:
                    kf_mask = np.arange(B) < n  # every tracked frame
            else:
                kf_mask = (fids_full % self.keyframe_interval == 0) & (
                    np.arange(B) < n
                )
            # Keep ONLY the fields the end-of-stream conversion loop reads.
            # Retaining the full ChunkResult (descriptors, keypoints, 3D
            # points) would pin ~1.5 MB of device buffers per chunk for the
            # whole run — an OOM on unbounded streams.
            rec = {
                "poses": result.poses,
                "num_matches": result.num_matches,
                "num_inliers": result.num_inliers,
                "pose_ok": result.pose_ok,
                "reloc_ok": reloc_ok,
                "n": n,
                "fids": fids_full,
                "kf_mask": kf_mask,
            }

            # ---- map: keyframes + landmarks + associations, one dispatch ----
            # (PnP mode folds the map inside the tracking chunk itself.)
            if pnp_mode:
                world_map = state.map
            else:
                map_fold = (
                    update_map_chunk_batched
                    if self.use_batched_map
                    else update_map_chunk
                )
                world_map, assoc = map_fold(
                    world_map,
                    assoc,
                    self._K,
                    jnp.asarray(fids_full),
                    jnp.asarray(kf_mask),
                    result.poses,
                    result.pose_ok,
                    result.kps_xy,
                    result.m_query,
                    result.m_train,
                    result.m_valid,
                    result.points3d,
                    result.point_ok,
                    gate_px=self.config.map.assoc_gate_px,
                    min_cand_depth=self.config.map.min_candidate_depth,
                )

            # ---- loop closure: detect + insert the whole chunk, ONE dispatch
            if self.loop_closure is not None and db is not None:
                kf_enabled_dev = jnp.asarray(kf_mask) & (
                    result.pose_ok | (jnp.asarray(fids_full) == 0)
                )
                db, lres = self._lc_chunk_jit(
                    db,
                    jnp.asarray(fids_full),
                    kf_enabled_dev,
                    result,
                    sub_lc,
                    B,
                    m=world_map if pnp_mode else None,
                )
                rec["loop"] = {
                    "success": lres.success,
                    "matched_keyframe_id": lres.matched_keyframe_id,
                    "num_inliers": lres.num_inliers,
                    "relative_transform": lres.relative_transform,
                }

            # ---- windowed bundle adjustment (once per chunk when due) ------
            kf_expected_since_ba += int(kf_mask.sum())
            if self.enable_ba and kf_expected_since_ba >= self.ba_interval:
                ba = bundle_adjust(
                    world_map, self._K, iterations=self.ba_iterations,
                    active_points=self.ba_active_points, rtol=self.ba_rtol,
                )
                world_map = ba.map
                if pnp_mode:
                    # shared-Map feedback: tracking continues against the
                    # optimised landmarks, from the optimised newest pose
                    pose2 = self._refreshed_pose(
                        world_map, jnp.asarray(True), state.vo.pose
                    )
                    state = state._replace(
                        map=world_map, vo=state.vo._replace(pose=pose2)
                    )
                rec["ba"] = {
                    "initial_cost": ba.initial_cost,
                    "final_cost": ba.final_cost,
                    "kf_id": world_map.kf_id,
                    "kf_valid": world_map.kf_valid,
                    "kf_R": world_map.kf_R,
                    "kf_t": world_map.kf_t,
                }
                kf_expected_since_ba = 0
            records.append(rec)
            frame_id += n

        # ---- single synchronization point: convert + fold ------------------
        poses_np: list[np.ndarray] = []
        loops: list[dict] = []
        ba_events: list[dict] = []
        ba_snapshots: list[dict] = []
        stats = {
            "num_matches": [], "num_inliers": [], "pose_ok": [], "reloc_ok": []
        }
        kf_fids: list[int] = []
        for rec in records:
            n, fids_full = rec["n"], rec["fids"]
            poses_np.append(np.array(rec["poses"][:n]))
            stats["num_matches"].append(np.asarray(rec["num_matches"])[:n])
            stats["num_inliers"].append(np.asarray(rec["num_inliers"])[:n])
            stats["reloc_ok"].append(np.asarray(rec["reloc_ok"])[:n])
            pose_ok_np = np.asarray(rec["pose_ok"])
            stats["pose_ok"].append(pose_ok_np[:n])
            kf_enabled = rec["kf_mask"] & (pose_ok_np | (fids_full == 0))
            kf_fids.extend(int(f) for f in fids_full[kf_enabled])
            if "loop" in rec:
                lres = rec["loop"]
                success_np = np.asarray(lres["success"])
                if success_np.any():
                    matched = np.asarray(lres["matched_keyframe_id"])
                    n_inl = np.asarray(lres["num_inliers"])
                    T_rel = np.asarray(lres["relative_transform"])
                    for b in np.nonzero(success_np)[0]:
                        loops.append(
                            {
                                "frame_id": int(fids_full[b]),
                                "matched_keyframe_id": int(matched[b]),
                                "num_inliers": int(n_inl[b]),
                                "relative_transform": T_rel[b],
                            }
                        )
            if "ba" in rec:
                ba = rec["ba"]
                ba_events.append(
                    {
                        "frame_id": kf_fids[-1] if kf_fids else 0,
                        "initial_cost": float(ba["initial_cost"]),
                        "final_cost": float(ba["final_cost"]),
                    }
                )
                ba_snapshots.append(ba)

        # ---- prepend the resumed segment's raw accumulations ----------------
        if resume is not None:
            poses_np.insert(0, np.asarray(resume["raw_poses"], np.float32))
            stats["num_matches"].insert(0, np.asarray(resume["stats_matches"]))
            stats["num_inliers"].insert(0, np.asarray(resume["stats_inliers"]))
            stats["pose_ok"].insert(0, np.asarray(resume["stats_pose_ok"]))
            stats["reloc_ok"].insert(
                0,
                np.asarray(resume["stats_reloc_ok"])
                if "stats_reloc_ok" in resume
                else np.zeros(len(np.asarray(resume["stats_pose_ok"])), bool),
            )
            kf_fids = [int(f) for f in np.asarray(resume["kf_fids"])] + kf_fids
            prior_loops = [
                {
                    "frame_id": int(f),
                    "matched_keyframe_id": int(m),
                    "num_inliers": int(ninl),
                    "relative_transform": np.asarray(T),
                }
                for f, m, ninl, T in zip(
                    np.asarray(resume["loops_frame"]),
                    np.asarray(resume["loops_matched"]),
                    np.asarray(resume["loops_ninl"]),
                    np.asarray(resume["loops_T"]),
                )
            ]
            loops = prior_loops + loops
            prior_snaps = [
                {
                    "kf_id": np.asarray(resume["ba_kf_id"][e]),
                    "kf_valid": np.asarray(resume["ba_kf_valid"][e]),
                    "kf_R": np.asarray(resume["ba_kf_R"][e]),
                    "kf_t": np.asarray(resume["ba_kf_t"][e]),
                }
                for e in range(len(np.asarray(resume["ba_frame"])))
            ]
            ba_snapshots = prior_snaps + ba_snapshots
            prior_events = [
                {
                    "frame_id": int(f),
                    "initial_cost": float(c[0]),
                    "final_cost": float(c[1]),
                }
                for f, c in zip(
                    np.asarray(resume["ba_frame"]), np.asarray(resume["ba_costs"])
                )
            ]
            ba_events = prior_events + ba_events

        raw_poses = (
            np.concatenate(poses_np) if poses_np else np.zeros((0, 4, 4), np.float32)
        )
        # BA events fold into the full trajectory in event order so each
        # window's correction also reaches the frames chained after it.
        all_poses = raw_poses
        for snap in ba_snapshots:
            all_poses = self._apply_ba_snapshot(snap, all_poses)
        pose_graph_applied = False
        if self.enable_pose_graph and loops and len(kf_fids) >= 2:
            all_poses = self._apply_pose_graph(all_poses, kf_fids, loops)
            pose_graph_applied = True
        W = self.ba_window
        snap_np = {
            "kf_id": np.stack([np.asarray(s["kf_id"]) for s in ba_snapshots])
            if ba_snapshots else np.zeros((0, W), np.int32),
            "kf_valid": np.stack([np.asarray(s["kf_valid"]) for s in ba_snapshots])
            if ba_snapshots else np.zeros((0, W), bool),
            "kf_R": np.stack([np.asarray(s["kf_R"]) for s in ba_snapshots])
            if ba_snapshots else np.zeros((0, W, 3, 3), np.float32),
            "kf_t": np.stack([np.asarray(s["kf_t"]) for s in ba_snapshots])
            if ba_snapshots else np.zeros((0, W, 3), np.float32),
        }
        stats_np = {
            k: np.concatenate(v) if v else np.zeros((0,))
            for k, v in stats.items()
        }
        checkpoint = {
            "carry_state": state,
            "world_map": world_map,
            "assoc": assoc,
            "db": db if db is not None else jnp.zeros(()),
            "counters": np.asarray(
                [frame_id, chunk_idx, kf_expected_since_ba], np.int64
            ),
            "raw_poses": raw_poses.astype(np.float32),
            "stats_matches": np.asarray(stats_np["num_matches"], np.int32),
            "stats_inliers": np.asarray(stats_np["num_inliers"], np.int32),
            "stats_pose_ok": np.asarray(stats_np["pose_ok"], bool),
            "stats_reloc_ok": np.asarray(stats_np["reloc_ok"], bool),
            "kf_fids": np.asarray(kf_fids, np.int32),
            "loops_frame": np.asarray(
                [lp["frame_id"] for lp in loops], np.int32
            ),
            "loops_matched": np.asarray(
                [lp["matched_keyframe_id"] for lp in loops], np.int32
            ),
            "loops_ninl": np.asarray(
                [lp["num_inliers"] for lp in loops], np.int32
            ),
            "loops_T": np.stack(
                [np.asarray(lp["relative_transform"], np.float32) for lp in loops]
            )
            if loops else np.zeros((0, 4, 4), np.float32),
            "ba_frame": np.asarray(
                [ev["frame_id"] for ev in ba_events], np.int32
            ),
            "ba_costs": np.asarray(
                [[ev["initial_cost"], ev["final_cost"]] for ev in ba_events],
                np.float32,
            ).reshape(-1, 2),
            "ba_kf_id": snap_np["kf_id"],
            "ba_kf_valid": snap_np["kf_valid"],
            "ba_kf_R": snap_np["kf_R"],
            "ba_kf_t": snap_np["kf_t"],
        }
        return {
            "poses": all_poses,
            "loops": loops,
            "ba_events": ba_events,
            "map": world_map,
            "pose_graph_applied": pose_graph_applied,
            "checkpoint": checkpoint,
            **stats_np,
        }

    def _apply_pose_graph(
        self, all_poses: np.ndarray, kf_fids: list[int], loops: list[dict]
    ) -> np.ndarray:
        """Optimise keyframe nodes with loop edges; propagate corrections.

        Every frame between keyframe k and k+1 inherits keyframe k's rigid
        correction: T_f ← T_k_opt · (T_k_orig⁻¹ · T_f_orig).
        """
        from tpuslam.backend.pose_graph import (
            add_edge,
            graph_from_trajectory,
            optimize_pose_graph,
        )

        fid_to_node = {fid: n for n, fid in enumerate(kf_fids)}
        kf_poses = jnp.asarray(all_poses[np.asarray(kf_fids)], jnp.float32)
        n_edges = len(kf_fids) - 1 + len(loops)
        g = graph_from_trajectory(kf_poses, max_edges=max(2 * n_edges, 8))
        slot = len(kf_fids) - 1
        n_loop_edges = 0
        for lp in loops:
            cand = fid_to_node.get(lp["matched_keyframe_id"])
            query = fid_to_node.get(lp["frame_id"])
            if cand is None or query is None or cand == query:
                continue
            # PnP gives x_query = R·X_cand + t ⇒ T_camc_camq = [R|t]⁻¹.
            T = np.asarray(lp["relative_transform"], np.float64)
            T_rel = np.linalg.inv(T)
            g = add_edge(g, slot, cand, query, jnp.asarray(T_rel, jnp.float32),
                         weight=self.config.map.loop_edge_weight)
            slot += 1
            n_loop_edges += 1
        if n_loop_edges == 0:
            return all_poses
        out = optimize_pose_graph(g, iterations=12)
        kf_opt = np.asarray(out.nodes[: len(kf_fids)], np.float64)

        # Vectorized fold (the per-frame Python loop this replaces was
        # O(frames) host matmuls per trajectory — real cost at KITTI
        # scale): each frame inherits the rigid correction of the last
        # keyframe at-or-before it, applied as one batched einsum.
        kf_arr = np.asarray(kf_fids)
        corrs = np.einsum(
            "nij,njk->nik", kf_opt,
            np.linalg.inv(np.asarray(all_poses, np.float64)[kf_arr]),
        )
        seg = np.searchsorted(kf_arr, np.arange(len(all_poses)), side="right") - 1
        covered = seg >= 0  # frames before the first keyframe keep their poses
        corrected = all_poses.copy()
        corrected[covered] = np.einsum(
            "fij,fjk->fik", corrs[seg[covered]],
            np.asarray(all_poses, np.float64)[covered],
        ).astype(all_poses.dtype)
        return corrected

    @staticmethod
    def _apply_ba_snapshot(snapshot: dict, all_poses: np.ndarray) -> np.ndarray:
        """Fold optimized keyframe poses into the trajectory, corrections forward.

        Each optimized keyframe overwrites its own trajectory entry, and every
        frame after it — up to the next optimized keyframe, or the end of the
        trajectory for the newest one — inherits its rigid correction
        ``T_f ← T_k_opt · T_k_orig⁻¹ · T_f`` (the same forward folding
        ``_apply_pose_graph`` does).  Without the propagation, frames chained
        past the BA window continue from uncorrected carries and the written
        trajectory jumps at the window boundary.
        """
        kf_ids = np.asarray(snapshot["kf_id"])
        kf_valid = np.asarray(snapshot["kf_valid"])
        R = np.asarray(snapshot["kf_R"])
        t = np.asarray(snapshot["kf_t"])
        n = len(all_poses)
        items = sorted(
            (int(kf_ids[s]), int(s))
            for s in np.nonzero(kf_valid)[0]
            if 0 <= kf_ids[s] < n
        )
        if not items:
            return all_poses
        corrected = all_poses.copy()
        for i, (fid, slot) in enumerate(items):
            end = items[i + 1][0] if i + 1 < len(items) else n
            T_opt = np.eye(4, dtype=np.float64)
            T_opt[:3, :3] = R[slot].T  # cam→world
            T_opt[:3, 3] = -R[slot].T @ t[slot]
            corr = T_opt @ np.linalg.inv(np.asarray(all_poses[fid], np.float64))
            corrected[fid:end] = np.einsum(
                "ij,fjk->fik", corr, np.asarray(all_poses[fid:end], np.float64)
            ).astype(all_poses.dtype)
        return corrected
