"""Time-sharded long-sequence mode: one video split across the device mesh.

SURVEY §5 ("long-context analog"): the reference streams frames strictly
sequentially with O(1) state (``preprocessor.cpp:95-141``); its only growth
axis is video length.  The accelerator-native scaling answer is *context
parallelism over time*: cut one long sequence into D contiguous segments,
track every segment independently on its own device (no collectives on the
hot path — monocular VO is embarrassingly parallel once cut), and stitch
the per-segment trajectories back into one by aligning each segment's
lead-in frames against the previous segment's already-stitched tail with a
Sim(3) transform (monocular scale is free per segment, so the alignment
must solve for scale too).

Layout (segment length S, overlap V, both multiples of the chunk batch):

    shard 0:  frames [0,            S + V)    core = local [0, S)
    shard d:  frames [d·S − V, (d+1)·S)       core = local [V, V + S)

Shard d's first V frames re-track the last V core frames of shard d−1, so
after both run, the duplicated stretch yields pose pairs from which the
inter-segment Sim(3) is estimated.  Rotation comes from the paired pose
orientations (a polar mean), NOT from Umeyama on camera centers — forward
motion makes centers collinear and the center-cloud rotation degenerate
about the motion axis.  Scale and translation then follow in closed form.

Wall-clock for an N-frame video drops from O(N) to O(N/D + V); the cost is
V extra tracked frames per shard and the (second-order) stitching error at
segment boundaries, measured by ``tests/test_timeshard.py`` against the
single-device trajectory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.dist.mesh import make_device_mesh, sequence_sharding


# --------------------------------------------------------------------------
# Host-side slicing
# --------------------------------------------------------------------------
def plan_time_shards(
    n_frames: int, n_shards: int, batch: int, overlap: int | None = None
) -> tuple[int, int]:
    """Choose (core segment length S, overlap V), both multiples of ``batch``.

    S covers the padded sequence: ``n_shards * S >= n_frames``.  The overlap
    defaults to one chunk — enough frames for a stable Sim(3) while keeping
    the redundant-tracking tax at V/S.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    V = batch if overlap is None else overlap
    if V < 2 or V % batch:
        raise ValueError("overlap must be a positive multiple of the batch size")
    S = -(-n_frames // n_shards)  # ceil
    S = -(-S // batch) * batch  # round up to a chunk multiple
    if n_shards > 1 and V > S:
        raise ValueError(f"overlap {V} exceeds segment length {S}")
    return S, V


def shard_frames_in_time(
    frames: np.ndarray, n_shards: int, batch: int, overlap: int | None = None
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Cut one (N, H, W) sequence into overlapping per-shard windows.

    Returns ``(shards (D, S+V, H, W), valid (D, S+V), S, V)``.  Frames past
    the end of the video pad the last shard and are marked invalid (the
    pipeline's masked no-op gates skip them; SURVEY §5 failure-detection
    row).
    """
    n = frames.shape[0]
    S, V = plan_time_shards(n, n_shards, batch, overlap)
    L = S + V
    pad_to = (n_shards - 1) * S + L if n_shards > 1 else L
    padded = np.concatenate(
        [frames, np.repeat(frames[-1:], max(pad_to - n, 0), axis=0)], axis=0
    )
    starts = [0] + [d * S - V for d in range(1, n_shards)]
    shards = np.stack([padded[s : s + L] for s in starts])
    valid = np.stack(
        [(np.arange(s, s + L) < n) for s in starts]
    )
    return shards, valid, S, V


def stage_shards_to_mesh(
    frames, n_shards: int, batch: int, mesh, overlap: int | None = None
):
    """Per-shard staging: one shard of frames in host RAM at a time.

    ``shard_frames_in_time`` materialises the full (D, S+V, H, W) stack on
    the host before one bulk ``device_put`` — fine for clips, ~2× the
    video in RAM for the long sequences time-sharding exists for.  This
    path slices each shard's window straight out of ``frames`` (which may
    be a disk-backed ``np.memmap`` — fancy indexing then reads only that
    shard's pages), puts it on ITS device, and assembles the global
    sharded array from the per-device buffers
    (``jax.make_array_from_single_device_arrays``), so peak host RSS is
    one shard, not the whole video.

    Returns ``(chunks (D, C, B, H, W) device-sharded, valid (D, C, B)
    host, S, V)``.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    n = len(frames)
    S, V = plan_time_shards(n, n_shards, batch, overlap)
    L = S + V
    D = n_shards
    C = L // batch
    frame_shape = frames[0].shape
    sh = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    devs = list(mesh.devices.reshape(-1))[:D]
    bufs = []
    valid_rows = []
    for d in range(D):
        s0 = 0 if d == 0 else d * S - V
        idx = np.minimum(np.arange(s0, s0 + L), n - 1)
        shard = np.ascontiguousarray(np.asarray(frames)[idx])
        bufs.append(
            jax.device_put(shard.reshape(1, C, batch, *frame_shape), devs[d])
        )
        valid_rows.append((np.arange(s0, s0 + L) < n).reshape(C, batch))
    chunks = jax.make_array_from_single_device_arrays(
        (D, C, batch, *frame_shape), sh, bufs
    )
    return chunks, np.stack(valid_rows), S, V


# --------------------------------------------------------------------------
# Device-side sharded tracking
# --------------------------------------------------------------------------
def _stage(frames, n_shards, batch, mesh, overlap):
    """Per-device staging when shards map 1:1 to mesh devices (flat host
    RSS, memmap-friendly); bulk staging otherwise."""
    if mesh.devices.size == n_shards:
        return stage_shards_to_mesh(frames, n_shards, batch, mesh, overlap)
    from tpuslam.dist.mesh import sequence_sharding as _sh

    shards, valid, S, V = shard_frames_in_time(
        np.asarray(frames), n_shards, batch, overlap
    )
    D, L = shards.shape[:2]
    C = L // batch
    chunks = jax.device_put(
        shards.reshape(D, C, batch, *shards.shape[2:]), _sh(mesh)
    )
    return chunks, valid.reshape(D, C, batch), S, V


def run_timesharded(
    pipeline,
    frames: np.ndarray,
    n_shards: int | None = None,
    overlap: int | None = None,
    seed: int = 0,
    mesh=None,
) -> dict:
    """Track one long sequence with its time axis sharded over the mesh.

    ``pipeline``: a ``SlamPipeline``; each shard runs its full one-dispatch
    sequence program (``process_sequence``) on its own device via ``vmap``
    over the shard axis + a ``NamedSharding`` on the mesh's sequence axis —
    per-shard VO state stays device-local, XLA inserts no collectives.

    Returns ``{"poses" (N, 4, 4), "pose_ok" (N,), "segments", "S", "V"}``
    with the stitched single trajectory in shard 0's frame.
    """
    if mesh is None:
        mesh = make_device_mesh(n_shards)
    if n_shards is None:
        n_shards = mesh.devices.size
    B = pipeline.config.batch_size
    n = len(frames)
    chunks, chunk_valid, S, V = _stage(frames, n_shards, B, mesh, overlap)
    D, C = chunk_valid.shape[:2]
    L = S + V

    sh = sequence_sharding(mesh)
    init = pipeline.initial_state()
    states = jax.tree.map(lambda x: jnp.broadcast_to(x, (D, *x.shape)), init)
    keys = jax.vmap(lambda s: jax.random.split(jax.random.PRNGKey(s), C))(
        seed + jnp.arange(D, dtype=jnp.uint32)
    )

    run = jax.jit(
        jax.vmap(pipeline.process_sequence),
        in_shardings=(sh, sh, jax.tree.map(lambda _: sh, init), sh),
    )
    results, _ = run(
        chunks,
        jax.device_put(chunk_valid, sh),
        states,
        keys,
    )
    poses = np.asarray(results.poses).reshape(D, L, 4, 4)
    pose_ok = np.asarray(results.pose_ok).reshape(D, L)

    stitched = stitch_segments(poses, S, V, n, pose_ok=pose_ok)
    core_ok = np.concatenate(
        [pose_ok[0, :S]] + [pose_ok[d, V : V + S] for d in range(1, D)]
    )[:n]
    return {
        "poses": stitched,
        "pose_ok": core_ok,
        "segments": poses,
        "S": S,
        "V": V,
    }


def run_timesharded_system(
    system,
    frames: np.ndarray,
    n_shards: int | None = None,
    overlap: int | None = None,
    seed: int = 0,
    mesh=None,
) -> dict:
    """Time-shard a FULL SLAM run (tracking + map + loop closure + BA).

    Each shard runs the complete ``SlamSystem._sequence_impl`` program —
    its own landmark map, keyframe DB and BA schedule — via
    ``shard_sequence_program`` (one unbatched program per core: the
    chunk-level ``lax.cond``s — LC verification skip, relocalization,
    PnP's RANSAC fallback — stay real branches; under ``vmap`` they
    lower to both-branches selects).  Host-side, each shard folds its own
    BA snapshots and pose-graph corrections into its LOCAL trajectory
    first, then the corrected cores stitch exactly as the VO mode does.

    Maps and keyframe DBs are per-shard (the context-parallel cut), so
    the in-scan detector only sees loops whose query and match fall in
    the same shard.  Loops ACROSS segment boundaries — the biggest loops
    on exactly the long sequences this mode exists for — are recovered by
    a host-side post-pass (:func:`cross_segment_loop_closure`): each
    shard's final DB is scored against the others', survivors are
    geometrically verified in one batched dispatch, and the verified
    edges feed a GLOBAL pose graph over all shards' core keyframes on the
    stitched trajectory (the matrix-free PCG solver scales to the node
    count).  Loop/BA events are reported with global frame ids,
    core-region only.
    """
    import jax.numpy as jnp

    from tpuslam.backend.map import empty_assoc, empty_map
    from tpuslam.dist.mesh import shard_sequence_program

    if mesh is None:
        mesh = make_device_mesh(n_shards)
    if n_shards is None:
        n_shards = mesh.devices.size
    B = system.config.batch_size
    n = len(frames)
    chunks, chunk_valid, S, V = _stage(frames, n_shards, B, mesh, overlap)
    D, C = chunk_valid.shape[:2]
    L = S + V

    db = (
        system.loop_closure.new_db(
            system.config.detector.max_keypoints,
            system.config.detector.descriptor_bytes,
        )
        if system.loop_closure is not None
        else jnp.zeros(())
    )
    if system.tracking == "pnp":
        carry0 = (
            system.pipeline.initial_pnp_state(), db, jnp.asarray(0, jnp.int32)
        )
    else:
        carry0 = (
            system.pipeline.initial_state(),
            empty_map(system.ba_window, system.max_map_points),
            empty_assoc(system.config.detector.max_keypoints),
            db,
            jnp.asarray(0, jnp.int32),
        )
    carries = jax.tree.map(lambda a: jnp.broadcast_to(a, (D, *a.shape)), carry0)
    keys = jax.vmap(lambda s: jax.random.split(jax.random.PRNGKey(s), C))(
        seed + jnp.arange(D, dtype=jnp.uint32)
    )
    sh = sequence_sharding(mesh)

    step = shard_sequence_program(system._sequence_impl, mesh)
    carry_f, outs = step(
        chunks,
        jax.device_put(jnp.asarray(chunk_valid), sh),
        carries,
        keys,
    )

    poses = np.array(outs["poses"]).reshape(D, L, 4, 4)  # writable copy
    pose_ok = np.asarray(outs["pose_ok"]).reshape(D, L)
    kf_enabled = np.asarray(outs["kf_enabled"]).reshape(D, L)

    # --- per-shard host folding: BA snapshots, then the pose graph ---------
    all_loops: list[dict] = []
    all_ba_events: list[dict] = []
    for d in range(D):
        offset = 0 if d == 0 else d * S - V
        if system.enable_ba and "ba_ran" in outs:
            ran = np.asarray(outs["ba_ran"][d])
            costs = np.asarray(outs["ba_costs"][d])
            for c in np.nonzero(ran)[0]:
                snap = {
                    "kf_id": np.asarray(outs["ba_kf_id"][d][c]),
                    "kf_valid": np.asarray(outs["ba_kf_valid"][d][c]),
                    "kf_R": np.asarray(outs["ba_kf_R"][d][c]),
                    "kf_t": np.asarray(outs["ba_kf_t"][d][c]),
                }
                poses[d] = system._apply_ba_snapshot(snap, poses[d])
                fid_local = int(min((c + 1) * B, L) - 1)
                core_lo = 0 if d == 0 else V
                if core_lo <= fid_local:
                    all_ba_events.append(
                        {
                            "frame_id": offset + fid_local,
                            "initial_cost": float(costs[c, 0]),
                            "final_cost": float(costs[c, 1]),
                        }
                    )
        loops_d: list[dict] = []
        if "loop" in outs:
            lres = outs["loop"]
            succ = np.asarray(lres.success[d]).reshape(-1)
            matched = np.asarray(lres.matched_keyframe_id[d]).reshape(-1)
            n_inl = np.asarray(lres.num_inliers[d]).reshape(-1)
            T_rel = np.asarray(lres.relative_transform[d]).reshape(-1, 4, 4)
            for f in np.nonzero(succ)[0]:
                loops_d.append(
                    {
                        "frame_id": int(f),
                        "matched_keyframe_id": int(matched[f]),
                        "num_inliers": int(n_inl[f]),
                        "relative_transform": T_rel[f],
                    }
                )
        kf_fids_d = [int(f) for f in np.nonzero(kf_enabled[d])[0]]
        if system.enable_pose_graph and loops_d and len(kf_fids_d) >= 2:
            poses[d] = system._apply_pose_graph(poses[d], kf_fids_d, loops_d)
        core_lo = 0 if d == 0 else V
        for lp in loops_d:
            if lp["frame_id"] >= core_lo:
                all_loops.append({**lp,
                                  "frame_id": offset + lp["frame_id"],
                                  "matched_keyframe_id": offset
                                  + lp["matched_keyframe_id"]})

    stitched = stitch_segments(poses, S, V, n, pose_ok=pose_ok)

    # --- cross-segment loop closure + global pose graph --------------------
    cross_loops: list[dict] = []
    if system.loop_closure is not None and D > 1:
        db_f = carry_f[1] if system.tracking == "pnp" else carry_f[3]
        cross_loops = cross_segment_loop_closure(
            system, db_f, D, S, V, n, seed=seed
        )
        if cross_loops and system.enable_pose_graph:
            # Global keyframe set: each shard's core keyframes at global
            # ids (lead-in keyframes duplicate the previous shard's tail
            # and are excluded).  Intra-shard loops ride along: they are
            # already satisfied by the per-shard correction, so their
            # residuals are ~0 and they anchor the segments' internal
            # consistency while the cross edges pull globally.
            global_kf: list[int] = []
            for d in range(D):
                lo = 0 if d == 0 else V
                hi = S if d == 0 else V + S
                offset = 0 if d == 0 else d * S - V
                for f in np.nonzero(kf_enabled[d])[0]:
                    if lo <= f < hi and offset + f < n:
                        global_kf.append(offset + int(f))
            if len(global_kf) >= 2:
                stitched = system._apply_pose_graph(
                    stitched, global_kf, all_loops + cross_loops
                )

    core_ok = np.concatenate(
        [pose_ok[0, :S]] + [pose_ok[d, V : V + S] for d in range(1, D)]
    )[:n]
    return {
        "poses": stitched,
        "pose_ok": core_ok,
        "segments": poses,
        "loops": all_loops + cross_loops,
        "cross_loops": cross_loops,
        "ba_events": all_ba_events,
        "S": S,
        "V": V,
    }


def cross_segment_loop_closure(
    system, db, D: int, S: int, V: int, n: int, seed: int = 0,
    budget: int | None = None,
) -> list[dict]:
    """Detect + verify loops whose query and match fall in DIFFERENT shards.

    Per-shard keyframe DBs make loops *within* a segment detectable but
    leave cross-boundary loops silently invisible — and on the exact
    workload time-sharding exists for (very long sequences), the biggest
    loops ARE cross-segment (round-4 verdict missing #3; the reference's
    single unbounded DB has no such blind spot,
    ``loop_closure.cpp:96-109``).  This host-side post-pass closes the
    gap off the hot path:

    1. score every shard's surviving core keyframes against every OTHER
       shard's DB — one (C, C) BoW matmul per shard pair on the host
       (the buffers are already in the final carry);
    2. gate on occupancy, core-region membership (lead-in rows duplicate
       the previous shard's tail), temporal distance > V +
       ``MinFramesDifference`` (cross-boundary *neighbours* are
       continuity, not loops) and ``MinAbsoluteScore``;
    3. keep the best candidate per query keyframe, budget the top
       scorers, and geometrically verify them in ONE batched device
       dispatch with the SAME branch-free verifier the in-shard chunk
       path uses (re-match + RANSAC DLT-PnP, ``LoopClosure._verify_impl``
       — false BoW candidates die here).

    Returns loop dicts in GLOBAL frame ids, same schema as
    ``SlamSystem.run_sequence``'s loops — ready for the global pose
    graph.
    """
    lc = system.loop_closure
    cfg = lc.config
    bow = np.asarray(db.bow)  # (D, C, W)
    ids = np.asarray(db.ids)  # (D, C)
    offsets = [0] + [d * S - V for d in range(1, D)]
    core_lo = [0] + [V] * (D - 1)
    core_hi = [S] + [V + S] * (D - 1)
    if budget is None:
        budget = max(2 * D, 8)

    cands: list[tuple[float, int, int, int, int]] = []
    for qd in range(1, D):
        okq = (ids[qd] >= core_lo[qd]) & (ids[qd] < core_hi[qd])
        gq = offsets[qd] + ids[qd]
        okq &= gq < n
        if not okq.any():
            continue
        for td in range(qd):
            okt = (ids[td] >= core_lo[td]) & (ids[td] < core_hi[td])
            gt = offsets[td] + ids[td]
            okt &= gt < n
            far = (
                np.abs(gq[:, None] - gt[None, :])
                > V + cfg.min_frames_difference
            )
            mask = okq[:, None] & okt[None, :] & far
            if not mask.any():
                continue
            scores = np.where(mask, bow[qd] @ bow[td].T, -np.inf)
            best_t = np.argmax(scores, axis=1)
            best_s = scores[np.arange(scores.shape[0]), best_t]
            for qs in np.nonzero(best_s >= cfg.min_absolute_score)[0]:
                cands.append(
                    (float(best_s[qs]), qd, int(qs), td, int(best_t[qs]))
                )
    if not cands:
        return []
    best_by_query: dict[tuple[int, int], tuple] = {}
    for c in cands:
        k = (c[1], c[2])
        if k not in best_by_query or c[0] > best_by_query[k][0]:
            best_by_query[k] = c
    chosen = sorted(best_by_query.values(), reverse=True)[:budget]

    desc = np.asarray(db.descriptors)
    xy = np.asarray(db.xy)
    kpv = np.asarray(db.kp_valid)
    mp = np.asarray(db.map_points)
    mpv = np.asarray(db.mp_valid)
    gather_q = lambda arr: jnp.asarray(  # noqa: E731
        np.stack([arr[qd, qs] for _, qd, qs, _, _ in chosen])
    )
    gather_t = lambda arr: jnp.asarray(  # noqa: E731
        np.stack([arr[td, ts] for _, _, _, td, ts in chosen])
    )
    Kc = len(chosen)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 909), Kc)
    ok_v, T_v, ninl_v = jax.jit(
        jax.vmap(
            lambda qd_, qx_, qk_, cd_, cx_, ck_, cm_, cv_, key: (
                lc._verify_impl(
                    qd_, qx_, qk_, cd_, cx_, ck_, cm_, cv_,
                    jnp.asarray(True), system._K, key,
                )
            )
        )
    )(
        gather_q(desc), gather_q(xy), gather_q(kpv),
        gather_t(desc), gather_t(xy), gather_t(kpv),
        gather_t(mp), gather_t(mpv), keys,
    )
    ok_np = np.asarray(ok_v)
    T_np = np.asarray(T_v)
    ninl_np = np.asarray(ninl_v)
    loops = []
    for i, (sc, qd, qs, td, ts) in enumerate(chosen):
        if not ok_np[i]:
            continue
        loops.append(
            {
                "frame_id": int(offsets[qd] + ids[qd, qs]),
                "matched_keyframe_id": int(offsets[td] + ids[td, ts]),
                "num_inliers": int(ninl_np[i]),
                "relative_transform": T_np[i],
                "bow_score": float(sc),
                "cross_segment": True,
            }
        )
    return loops


# --------------------------------------------------------------------------
# Host-side Sim(3) stitching
# --------------------------------------------------------------------------
def _centers(T: np.ndarray) -> np.ndarray:
    return np.asarray(T, np.float64)[:, :3, 3]


def sim3_from_pose_pairs(
    T_src: np.ndarray, T_dst: np.ndarray
) -> tuple[np.ndarray, np.ndarray, float]:
    """Sim(3) (R, t, s) with ``T_dst ≈ [s·R|t] ∘ T_src`` from paired poses.

    Rotation is the polar mean of the paired orientations
    (argmin_R Σ‖R·R_srcᵢ − R_dstᵢ‖²  =  polar(Σ R_dstᵢ R_srcᵢᵀ)) — robust
    where center-cloud Umeyama degenerates (collinear forward motion leaves
    the rotation about the motion axis unconstrained).  Scale/translation
    are then the closed-form least squares on the camera centers.
    """
    T_src = np.asarray(T_src, np.float64)
    T_dst = np.asarray(T_dst, np.float64)
    M = np.einsum("nij,nkj->ik", T_dst[:, :3, :3], T_src[:, :3, :3])
    U, _, Vt = np.linalg.svd(M)
    Sg = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Sg[2, 2] = -1
    R = U @ Sg @ Vt
    cs, cd = _centers(T_src), _centers(T_dst)
    mu_s, mu_d = cs.mean(axis=0), cd.mean(axis=0)
    xs = (cs - mu_s) @ R.T
    xd = cd - mu_d
    denom = float((xs**2).sum())
    s = float((xs * xd).sum() / denom) if denom > 1e-18 else 1.0
    if s <= 1e-12:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def apply_sim3(R: np.ndarray, t: np.ndarray, s: float, T: np.ndarray) -> np.ndarray:
    """Apply a Sim(3) to (N, 4, 4) world-from-camera poses.

    Camera centers map by C ← s·R·C + t; orientations by R_wc ← R·R_wc
    (scale acts on the translation part only — the camera frame itself is
    rigid).
    """
    T = np.asarray(T, np.float64)
    out = np.tile(np.eye(4), (T.shape[0], 1, 1))
    out[:, :3, :3] = R @ T[:, :3, :3]
    out[:, :3, 3] = (s * (T[:, :3, 3] @ R.T)) + t
    return out


def stitch_segments(
    poses: np.ndarray,
    S: int,
    V: int,
    n_frames: int,
    pose_ok: np.ndarray | None = None,
) -> np.ndarray:
    """Fold per-shard trajectories (D, S+V, 4, 4) into one (n_frames, 4, 4).

    Each shard's V lead-in poses re-track the previous shard's last V core
    frames; the Sim(3) aligning those pairs maps the shard's local frame
    into the (already stitched) global frame, cumulatively.

    ``pose_ok`` (D, S+V): a pair participates in the Sim(3) fit only when
    BOTH sides tracked it — a dropout inside an overlap otherwise feeds
    two poses with different failure histories into the unweighted fit and
    misplaces every downstream segment.  Fewer than 2 usable pairs falls
    back to all pairs (degraded, but defined).
    """
    D = poses.shape[0]
    if pose_ok is None:
        pose_ok = np.ones(poses.shape[:2], bool)
    out = np.asarray(poses[0], np.float64).copy()  # covers [0, S+V)
    out = out[:S] if D > 1 else out
    stitched = [out]
    ok_tail = pose_ok[0, :S]  # ok flags of the stitched frames so far (tail)
    total = S
    for d in range(1, D):
        ref = np.concatenate(stitched)[total - V : total]
        pair_ok = pose_ok[d, :V] & ok_tail[-V:]
        if pair_ok.sum() < 2:
            pair_ok = np.ones(V, bool)
        R, t, s = sim3_from_pose_pairs(poses[d, :V][pair_ok], ref[pair_ok])
        core = apply_sim3(R, t, s, poses[d, V : V + S])
        stitched.append(core)
        ok_tail = pose_ok[d, V : V + S]
        total += S
    full = np.concatenate(stitched)
    return np.asarray(full[:n_frames], np.float32)
