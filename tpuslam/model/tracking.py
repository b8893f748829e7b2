"""PnP tracking against the persistent map (BASELINE config 2).

Pure two-view VO chains unit-baseline relative poses and recovers scale
from depth-ratio medians — every frame's scale estimate compounds.  This
module instead tracks each frame *absolutely* against the metric map the
pipeline itself builds: the landmarks a frame re-observes (chained through
match indices exactly as :func:`tpuslam.backend.map.update_map_chunk`) give
3D↔2D correspondences, and batched RANSAC DLT-PnP
(:mod:`tpuslam.backend.pnp`) yields the world→camera pose directly — no
scale chaining, drift bounded by map quality rather than by the product of
per-pair ratio estimates.

This is the Map-centric design the reference declares but never implements:
persistent landmarks (``include/slam/backend/map.hpp:9-21``) consumed by a
tracking loop (``model.hpp:20-27`` commented-out members).  The reference's
only PnP lives in loop-closure verification (``loop_closure.cpp:238-274``);
here the same solver runs every frame.

Structure: the frame-parallel two-view stage still runs batched (matching,
essential RANSAC, unit triangulation); the inherently sequential part —
associate → PnP → pose → map insert — is one ``lax.scan`` over the chunk,
with masked fallbacks (scaled two-view pose when PnP has too few landmark
hits, identity when both fail) so fixed-shape execution never breaks.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuslam.backend.map import (
    AssocState,
    MapState,
    add_observations,
    apply_row_select,
    insert_keyframe,
    insert_points,
    row_select,
)
from tpuslam.backend.pnp import motion_pnp, ransac_pnp


class TrackChunkResult(NamedTuple):
    poses: jax.Array  # (B, 4, 4) T_world_cam
    pnp_ok: jax.Array  # (B,) bool — PnP produced this frame's pose
    num_pnp_inliers: jax.Array  # (B,) int32
    scale: jax.Array  # (B,) float32 — metric baseline applied to the pair
    num_assoc: jax.Array  # (B,) int32 — live landmark associations fed to PnP
    used_ransac: jax.Array  # (B,) bool — RANSAC fallback cond taken (costly;
    # healthy frames descend from the motion prior instead)
    point_count0: jax.Array  # (B,) int32 — map point_count BEFORE each
    # frame's inserts (birth watermark: relocalization re-anchors exactly
    # the landmarks born at-or-after a corrected frame)
    kp_to_point: jax.Array  # (B, K) int32 — per-frame landmark association
    kp_birth: jax.Array  # (B, K) int32 — allocation guard for kp_to_point.
    # The loop-closure DB stores each keyframe's map points through these
    # (multi-view landmark positions), not the one-pair triangulations:
    # pair-depth noise measured bad enough to break relocalization's
    # depth-ratio scale (bimodal stored/unit ratios 1.0-4.2 on a fixture
    # frame whose landmark depths were clean).


def _pose_from_rt(R_cw: jax.Array, t_cw: jax.Array) -> jax.Array:
    """[R|t] world→cam → 4×4 T_world_cam."""
    R_wc = jnp.swapaxes(R_cw, -1, -2)
    top = jnp.concatenate([R_wc, (-(R_wc @ t_cw[..., :, None]))], axis=-1)
    bottom = jnp.asarray([[0.0, 0.0, 0.0, 1.0]], dtype=R_cw.dtype)
    return jnp.concatenate([top, bottom], axis=-2)


@partial(
    jax.jit,
    static_argnames=(
        "pnp_hypotheses", "pnp_min_inliers", "pnp_min_inlier_frac",
        "pnp_min_coverage", "gate_px", "min_cand_depth", "unroll",
        "gn_iters", "freeze_map", "loc_assoc_radius_px",
    ),
)
def pnp_track_chunk(
    m: MapState,
    assoc: AssocState,
    K: jax.Array,  # (3, 3)
    T_prev0: jax.Array,  # (4, 4) pose of the frame before the chunk
    frame_ids: jax.Array,  # (B,) int32
    frame_valid: jax.Array,  # (B,) bool
    keys: jax.Array,  # (B, 2) PRNG keys for PnP sampling
    R_rel: jax.Array,  # (B, 3, 3) two-view [R|t]: x_cur = R x_prev + t
    t_rel: jax.Array,  # (B, 3) unit-baseline translation
    vo_ok: jax.Array,  # (B,) bool — two-view estimate succeeded
    kps_xy: jax.Array,  # (B, K, 2)
    m_query: jax.Array,  # (B, M) int32
    m_train: jax.Array,  # (B, M) int32
    m_valid: jax.Array,  # (B, M) bool
    X_cur_unit: jax.Array,  # (B, M, 3) unit-baseline triangulation, cur cam
    z_prev_unit: jax.Array,  # (B, M) unit-baseline depth in the prev cam
    point_ok: jax.Array,  # (B, M) bool
    *,
    pnp_hypotheses: int = 64,
    pnp_min_inliers: int = 12,
    pnp_min_inlier_frac: float = 0.4,
    pnp_min_coverage: float = 0.4,
    gate_px: float = 8.0,
    min_cand_depth: float = 0.2,
    unroll: int = 1,
    gn_iters: int = 4,
    freeze_map: bool = False,
    loc_assoc_radius_px: float = 48.0,
) -> tuple[TrackChunkResult, MapState, AssocState, jax.Array]:
    """Track a chunk of frames against the map; returns poses + new state.

    Every valid frame becomes a keyframe in the sliding window (the map is
    the tracking reference, so it must stay current).  Returns
    ``(result, map, assoc, T_last)``.

    ``freeze_map=True`` is localization-only mode: the map is a loaded,
    immutable reference — no point/keyframe/observation inserts — while
    landmark association still chains through re-observations (the
    association carry never needs new points to keep tracking against a
    complete prebuilt map).
    """

    def step(carry, xs):
        m, a, T_prev = carry
        (fid, fv, key, Rr, tr, vok, xy, q, t, mv, Xc_u, zp_u, ok_pt) = xs

        qc = jnp.maximum(q, 0)
        tc = jnp.maximum(t, 0)
        uv_cur = xy[tc]

        # --- landmark association via the previous frame's keypoints --------
        cand_slot = a.kp_to_point[qc]
        cand_birth = a.kp_birth[qc]
        alive = (
            mv
            & (cand_slot >= 0)
            & (m.point_birth[jnp.maximum(cand_slot, 0)] == cand_birth)
            & m.point_valid[jnp.maximum(cand_slot, 0)]
        )
        if freeze_map:
            # --- projection refresh against the frozen map ------------------
            # The match-chain association above still works on a frozen map
            # (links form at the a2 write below, no inserts needed), but it
            # can only RETAIN landmarks — never acquire them — so it decays
            # and cannot bootstrap.  When coverage drops below the PnP
            # coverage floor, refresh under a real cond: project every
            # valid landmark with the previous pose and take the nearest
            # projection within a radius (classic visible-point data
            # association; the Huber-IRLS solve + inlier gates absorb what
            # a descriptorless radius test lets in).  The (M, P) table
            # is large, so it must not run on healthy frames.
            n_match_f = jnp.sum(mv.astype(jnp.int32)).astype(jnp.float32)
            need_refresh = jnp.sum(alive.astype(jnp.int32)).astype(
                jnp.float32
            ) < (pnp_min_coverage * jnp.maximum(n_match_f, 1.0))

            def _proj_assoc(_):
                R_cw_p0 = jnp.swapaxes(T_prev[:3, :3], 0, 1)
                t_cw_p0 = -R_cw_p0 @ T_prev[:3, 3]
                Xc_all = m.points @ R_cw_p0.T + t_cw_p0  # (P, 3)
                z_all = Xc_all[:, 2]
                pixp = Xc_all @ K.T
                uvp = pixp[:, :2] / jnp.maximum(pixp[:, 2:3], 1e-9)
                proj_ok = m.point_valid & (z_all > min_cand_depth)
                d2 = (
                    jnp.sum(uv_cur**2, axis=1)[:, None]
                    + jnp.sum(uvp**2, axis=1)[None, :]
                    - 2.0 * jnp.matmul(uv_cur, uvp.T, precision="highest")
                )
                d2 = jnp.where(proj_ok[None, :], d2, jnp.inf)
                nearest = jnp.argmin(d2, axis=1).astype(jnp.int32)
                nd2 = jnp.take_along_axis(d2, nearest[:, None], 1)[:, 0]
                found = mv & (nd2 < loc_assoc_radius_px * loc_assoc_radius_px)
                return jnp.where(found, nearest, -1), found

            def _keep_chain(_):
                return jnp.where(alive, cand_slot, -1), alive

            cand_slot, alive = jax.lax.cond(
                need_refresh, _proj_assoc, _keep_chain, None
            )
            cand_birth = m.point_birth[jnp.maximum(cand_slot, 0)]
        X_map = m.points[jnp.maximum(cand_slot, 0)]  # (M, 3) world

        # --- fallback / seed: two-view pose at map-anchored scale ------------
        # Baseline scale from depths: the same landmarks seen by the previous
        # camera have metric depth z_map_prev = (R_prev X + t_prev)_z and
        # unit-pair depth z_prev_unit; their ratio is the metric baseline.
        R_cw_p = jnp.swapaxes(T_prev[:3, :3], 0, 1)
        t_cw_p = -R_cw_p @ T_prev[:3, 3]
        z_map_prev = (X_map @ R_cw_p.T + t_cw_p)[:, 2]
        r_ok = alive & ok_pt & (zp_u > 1e-3) & (z_map_prev > 1e-3)
        ratio = jnp.where(r_ok, z_map_prev / jnp.maximum(zp_u, 1e-9), jnp.nan)
        s_fb = jnp.clip(jnp.nan_to_num(jnp.nanmedian(ratio), nan=1.0), 0.05, 20.0)
        s_fb = jnp.where(jnp.sum(r_ok) >= 5, s_fb, 1.0)
        T_rel_fb = _pose_from_rt(Rr, tr * s_fb)  # T_prev_cur
        T_fb = T_prev @ T_rel_fb

        # --- absolute pose against the map -----------------------------------
        # Healthy path: seeded Huber-IRLS Gauss-Newton from the two-view
        # pose (motion_pnp) — no hypothesis stage, so the scan's sequential
        # spine loses RANSAC's 66-round Jacobi chain.  RANSAC PnP survives under a ``lax.cond`` for
        # frames where descent from the prior fails its gates AND the map
        # coverage says an absolute solve could win — only poses and the
        # (M,)-sized correspondence arrays cross the branch boundary.
        T_seed = jnp.where(vok & fv, T_fb, T_prev)
        R_cw_s = jnp.swapaxes(T_seed[:3, :3], 0, 1)
        # Annealed Huber schedule always ends at the 2 px gate width;
        # fewer rounds start the anneal narrower.
        schedule = (16.0, 8.0, 4.0, 2.0)[: gn_iters - 1] + (2.0,)
        gn = motion_pnp(
            K, R_cw_s, -R_cw_s @ T_seed[:3, 3], X_map, uv_cur, alive,
            iters=gn_iters, min_inliers=pnp_min_inliers,
            huber_schedule=schedule,
        )

        # A PnP solve that explains only a small fraction of the live
        # associations is a mis-solve on noisy landmarks, not a pose: the
        # absolute inlier floor alone let 18-of-76-inlier "successes"
        # override a good two-view fallback (measured 2.4× worse speed-
        # profile tracking on the variable-speed scene).  Require the
        # inliers to cover a minimum fraction of what PnP was given.
        n_alive = jnp.sum(alive.astype(jnp.int32))

        def frac_gate(n_inl):
            return n_inl.astype(jnp.float32) >= (
                pnp_min_inlier_frac * n_alive.astype(jnp.float32)
            )

        # Map-coverage gate: when the live landmarks explain only a small
        # fraction of the frame's matches, absolute PnP is fitting a thin,
        # noisy subset while the fallback pools a robust median over the
        # full match set — prefer the fallback (measured: PnP poses from
        # ~25%-coverage maps tracked a 2× speed change 10× worse than the
        # map-anchored fallback on the variable-speed scene).
        n_match = jnp.sum(mv.astype(jnp.int32))
        cov_ok = n_alive.astype(jnp.float32) >= (
            pnp_min_coverage * jnp.maximum(n_match, 1).astype(jnp.float32)
        )
        gn_ok = gn.success & frac_gate(gn.num_inliers) & cov_ok & fv

        def _use_gn(_key):
            return gn.R, gn.t, gn.num_inliers, gn.success

        def _use_ransac(rk):
            p = ransac_pnp(
                X_map, uv_cur, alive, K, rk,
                num_hypotheses=pnp_hypotheses, min_inliers=pnp_min_inliers,
                solver_sweeps=8, hyp_sweeps=6, lo_rounds=1, refine="gn",
            )
            return p.R, p.t, p.num_inliers, p.success

        need_ransac = fv & cov_ok & ~gn_ok
        R_p, t_p, n_inl, succ = jax.lax.cond(need_ransac, _use_ransac, _use_gn, key)
        T_pnp = _pose_from_rt(R_p, t_p)
        pnp_ok = succ & frac_gate(n_inl) & cov_ok & fv
        T_cur = jnp.where(pnp_ok, T_pnp, jnp.where(vok & fv, T_fb, T_prev))

        # --- metric scale actually applied to this pair ----------------------
        # ‖(T_prev⁻¹T_cur)[:3,3]‖ = ‖R_prevᵀ(C_cur−C_prev)‖ = ‖C_cur−C_prev‖:
        # the camera-center distance, no 4×4 LU solve needed (linalg.solve
        # on a tiny matrix is a disproportionately long dependent chain
        # inside this per-frame scan).
        s_used = jnp.linalg.norm(T_cur[:3, 3] - T_prev[:3, 3])

        # --- map update (same gating as update_map_chunk) --------------------
        enabled = fv & ((pnp_ok | vok) | (m.kf_count == 0))
        R_cw_c = jnp.swapaxes(T_cur[:3, :3], 0, 1)
        Xc_cand = (X_map - T_cur[:3, 3][None, :]) @ R_cw_c.T
        z_cand = Xc_cand[:, 2]
        pix = Xc_cand @ K.T
        uv_pred = pix[:, :2] / jnp.maximum(pix[:, 2:3], 1e-9)
        gate = (z_cand > min_cand_depth) & (
            jnp.sum((uv_pred - uv_cur) ** 2, axis=-1) < gate_px * gate_px
        )
        obs_alive = alive & gate
        assoc_slot = jnp.where(obs_alive, cand_slot, -1)

        if freeze_map:
            # Frozen map: no point/keyframe/observation inserts — and no
            # masked-no-op insert machinery either (its dense scatter
            # tables cost real work even fully masked).
            m5 = m
            new_mask = jnp.zeros_like(mv)
            pt_slot = assoc_slot
            kf_slot = jnp.asarray(-1, jnp.int32)
        else:
            X_world = (
                jnp.einsum(
                    "ij,mj->mi", T_cur[:3, :3], Xc_u * s_used,
                    precision="highest",
                )
                + T_cur[:3, 3][None, :]
            )
            new_mask = ok_pt & (assoc_slot < 0) & enabled
            m2, new_slots = insert_points(m, X_world, new_mask)
            pt_slot = jnp.where(assoc_slot >= 0, assoc_slot, new_slots)

            t_cw_c = -R_cw_c @ T_cur[:3, 3]
            m3, kf_slot = insert_keyframe(m2, fid, R_cw_c, t_cw_c, enabled)
            obs_ok = (obs_alive | new_mask) & enabled
            m4 = add_observations(
                m3, jnp.maximum(kf_slot, 0), pt_slot, uv_cur, obs_ok
            )

            # second view for brand-new points in the previous keyframe
            uv_prev = a.prev_xy[qc]
            pks = jnp.maximum(a.prev_kf_slot, 0)
            Xc_prev = X_world @ m4.kf_R[pks].T + m4.kf_t[pks][None, :]
            pix_p = Xc_prev @ K.T
            uv_pred_p = pix_p[:, :2] / jnp.maximum(pix_p[:, 2:3], 1e-9)
            gate_p = (Xc_prev[:, 2] > min_cand_depth) & (
                jnp.sum((uv_pred_p - uv_prev) ** 2, axis=-1)
                < gate_px * gate_px
            )
            m5 = add_observations(
                m4, pks, new_slots, uv_prev,
                new_mask & (a.prev_kf_slot >= 0) & gate_p,
            )

        # --- propagate landmark identity -------------------------------------
        # Both payloads (map slot + birth guard) ride ONE writer-selection
        # table: the (K, M) equality/argmax build dominates the payload
        # apply, and the indices are identical.
        k_cap = a.kp_to_point.shape[0]
        carry_ok = mv & (pt_slot >= 0) & (obs_alive | new_mask)
        birth_of = m5.point_birth[jnp.maximum(pt_slot, 0)]
        sel_k, written_k = row_select(tc, carry_ok, k_cap)
        payload = apply_row_select(
            sel_k, written_k, jnp.stack([pt_slot, birth_of], axis=1)
        )
        kp_to_point = jnp.where(written_k, payload[:, 0], -1)
        kp_birth = jnp.where(written_k, payload[:, 1], -1)
        a2 = AssocState(
            kp_to_point=kp_to_point,
            kp_birth=kp_birth,
            prev_kf_slot=jnp.where(enabled, kf_slot, jnp.asarray(-1, jnp.int32)),
            prev_xy=xy,
        )
        out = (T_cur, pnp_ok, n_inl, s_used,
               jnp.sum(alive.astype(jnp.int32)), need_ransac, m.point_count,
               a2.kp_to_point, a2.kp_birth)
        return (m5, a2, T_cur), out

    (m_out, a_out, T_last), (
        poses, pnp_ok, n_inl, scale, n_assoc, used_ransac, point_count0,
        kp_to_point, kp_birth,
    ) = jax.lax.scan(
        step,
        (m, assoc, T_prev0),
        (
            frame_ids,
            frame_valid,
            keys,
            R_rel,
            t_rel,
            vo_ok,
            kps_xy,
            m_query,
            m_train,
            m_valid,
            X_cur_unit,
            z_prev_unit,
            point_ok,
        ),
        unroll=unroll,
    )
    return (
        TrackChunkResult(
            poses=poses, pnp_ok=pnp_ok, num_pnp_inliers=n_inl, scale=scale,
            num_assoc=n_assoc, used_ransac=used_ransac,
            point_count0=point_count0,
            kp_to_point=kp_to_point, kp_birth=kp_birth,
        ),
        m_out,
        a_out,
        T_last,
    )
