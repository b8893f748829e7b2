"""Fixed-shape world map: keyframe poses + 3D points + observations.

The reference declares (but never implements) a mutex-guarded ``Map`` with
``insertKeyframe`` / ``insertMapPoint`` (``include/slam/backend/map.hpp:9-21``
— header-only skeleton, no .cpp).  The accelerator-native equivalent is an immutable
pytree of capacity-bounded buffers updated functionally: no mutex, no shared
mutable state — the "thread safety" of the reference design is obsolete by
construction (SURVEY §5).

Observations are stored as a dense (W keyframes × P points) grid with a
mask — the layout bundle adjustment consumes directly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def row_select(
    slots: jax.Array,  # (M,) int32 target rows (may repeat; OOB = dropped)
    valid: jax.Array,  # (M,) bool
    out_rows: int,
) -> tuple[jax.Array, jax.Array]:
    """One-hot writer-selection table for a dense scatter.

    Returns ``(sel_first (out_rows, M) one-hot bool, written (out_rows,))``.
    Factored out of :func:`scatter_rows_dense` so callers scattering
    SEVERAL payloads along the same ``(slots, valid)`` build the equality
    table / argmax once (the table build dominates the payload apply —
    sharing it across the two association-propagation scatters in the
    per-frame tracking scan halves that cost).
    """
    eff = jnp.where(valid, slots, -1)
    sel = eff[None, :] == jnp.arange(out_rows, dtype=slots.dtype)[:, None]
    written = jnp.any(sel, axis=1)  # (out_rows,)
    # First valid occurrence wins on duplicate slots; with the mask the
    # selection matrix is one-hot per row, so the "gather" is a matmul.
    # First-occurrence via argmax (one reduction pass) in place of a row
    # cumsum over the full (out_rows, M) table.
    first = jnp.argmax(sel, axis=1)  # (out_rows,) — 0 when the row is empty
    sel_first = (
        jnp.arange(sel.shape[1], dtype=jnp.int32)[None, :] == first[:, None]
    ) & written[:, None]
    return sel_first, written


def apply_row_select(
    sel_first: jax.Array,  # (out_rows, M) one-hot bool from row_select
    written: jax.Array,  # (out_rows,) bool from row_select
    values: jax.Array,  # (M, D) or (M,) payload
) -> jax.Array:
    """Gather one payload through a precomputed writer-selection table."""
    v2 = values[:, None] if values.ndim == 1 else values
    if jnp.issubdtype(values.dtype, jnp.integer):
        # Integer payloads (slots, birth counters) must stay exact for any
        # value — a float32 matmul rounds above 2^24, which would corrupt
        # birth ids after ~110k frames.  The selection is one-hot per row,
        # so a masked max over the already-materialised (out_rows, M) table
        # is exact for all int32 and stays vector work (no row gather).
        lo = jnp.iinfo(v2.dtype).min
        new_rows = jnp.max(
            jnp.where(sel_first[:, :, None], v2[None, :, :], lo), axis=1
        )
        new_rows = jnp.where(written[:, None], new_rows, 0)
    else:
        new_rows = jnp.matmul(
            sel_first.astype(jnp.float32),
            v2.astype(jnp.float32),
            precision="highest",
        )
    new_rows = new_rows.astype(v2.dtype)
    if values.ndim == 1:
        new_rows = new_rows[:, 0]
    return new_rows


def scatter_rows_dense(
    values: jax.Array,  # (M, D) or (M,) source values
    slots: jax.Array,  # (M,) int32 target rows (may repeat; OOB = dropped)
    valid: jax.Array,  # (M,) bool
    out_rows: int,
) -> tuple[jax.Array, jax.Array]:
    """Dense scatter: returns (new_rows (out_rows, D), written (out_rows,)).

    XLA lowers ``x.at[idx].set`` to a scatter op, which can execute close
    to serially.  This reformulation is pure vector work: a
    (out_rows, M) equality table, an argmax per row to pick a writer
    (first valid occurrence wins on duplicates), and a row gather — see
    :func:`row_select` / :func:`apply_row_select` for the shared-table
    form used when several payloads scatter along the same indices.
    """
    sel_first, written = row_select(slots, valid, out_rows)
    return apply_row_select(sel_first, written, values), written


def _apply_row_scatter(
    target: jax.Array,  # (P,) or (P, D)
    values: jax.Array,  # (M,) or (M, D)
    slots: jax.Array,
    valid: jax.Array,
) -> jax.Array:
    new_rows, written = scatter_rows_dense(values, slots, valid, target.shape[0])
    w = written.reshape(written.shape + (1,) * (target.ndim - 1))
    return jnp.where(w, new_rows, target)


class MapState(NamedTuple):
    """World state (pytree).  W = keyframe window capacity, P = point capacity."""

    kf_R: jax.Array  # (W, 3, 3) — world→camera rotation (x_c = R X + t)
    kf_t: jax.Array  # (W, 3)
    kf_id: jax.Array  # (W,) int32 — frame id (-1 = empty)
    kf_valid: jax.Array  # (W,) bool
    points: jax.Array  # (P, 3) — world coordinates
    point_valid: jax.Array  # (P,) bool
    point_birth: jax.Array  # (P,) int32 — allocation counter at insertion
    obs_uv: jax.Array  # (W, P, 2) — pixel observation of point j in keyframe i
    obs_mask: jax.Array  # (W, P) bool
    kf_count: jax.Array  # () int32 — total keyframes ever inserted
    point_count: jax.Array  # () int32 — total points ever inserted

    @property
    def window(self) -> int:
        return self.kf_R.shape[0]

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def empty_map(window: int = 8, max_points: int = 4096) -> MapState:
    return MapState(
        kf_R=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (window, 3, 3)),
        kf_t=jnp.zeros((window, 3), jnp.float32),
        kf_id=jnp.full((window,), -1, jnp.int32),
        kf_valid=jnp.zeros((window,), bool),
        points=jnp.zeros((max_points, 3), jnp.float32),
        point_valid=jnp.zeros((max_points,), bool),
        point_birth=jnp.full((max_points,), -1, jnp.int32),
        obs_uv=jnp.zeros((window, max_points, 2), jnp.float32),
        obs_mask=jnp.zeros((window, max_points), bool),
        kf_count=jnp.asarray(0, jnp.int32),
        point_count=jnp.asarray(0, jnp.int32),
    )


@jax.jit
def insert_keyframe(
    m: MapState,
    frame_id: jax.Array,
    R: jax.Array,
    t: jax.Array,
    enabled: jax.Array | bool = True,
) -> tuple[MapState, jax.Array]:
    """Insert a keyframe pose into the sliding window (ring slot).

    Returns (new map, slot index).  The analog of ``Map::insertKeyframe``
    (``map.hpp:12``); on overflow the oldest slot is recycled and its
    observations cleared.  With ``enabled=False`` the call is a masked
    no-op (slot −1) so it can live inside a ``scan`` over frames.
    """
    enabled = jnp.asarray(enabled)
    slot = m.kf_count % m.window

    # Clipped-index row updates select old-vs-new instead of OOB-dropping:
    # single-index `.at[i].set(..., mode="drop")` still lowers to a scatter
    # op; a select + in-bounds `.at[i].set` is a
    # dynamic-update-slice.
    def row(buf, new):
        old = buf[slot]
        e = enabled.reshape((1,) * old.ndim) if old.ndim else enabled
        return buf.at[slot].set(jnp.where(e, new, old))

    return (
        m._replace(
            kf_R=row(m.kf_R, R),
            kf_t=row(m.kf_t, t),
            kf_id=row(m.kf_id, jnp.asarray(frame_id, jnp.int32)),
            kf_valid=row(m.kf_valid, True),
            obs_uv=row(m.obs_uv, jnp.zeros_like(m.obs_uv[0])),
            obs_mask=row(m.obs_mask, jnp.zeros_like(m.obs_mask[0])),
            kf_count=m.kf_count + enabled.astype(jnp.int32),
        ),
        jnp.where(enabled, slot, -1),
    )


@jax.jit
def insert_points(
    m: MapState, new_points: jax.Array, new_valid: jax.Array
) -> tuple[MapState, jax.Array]:
    """Append up to N new 3D points (ring allocation).

    ``new_points``: (N, 3); ``new_valid``: (N,) — invalid entries are not
    written.  Returns (new map, (N,) slot indices).  The analog of
    ``Map::insertMapPoint`` (``map.hpp:16``) batched.
    """
    # Sequential slots for valid entries, allocated from point_count.
    n = new_points.shape[0]
    offsets = jnp.cumsum(new_valid.astype(jnp.int32)) - 1
    slots = (m.point_count + offsets) % m.capacity
    # The allocated slots form a contiguous (mod-capacity) window of ≤ n
    # rows starting at point_count, so the dense-scatter equality tables
    # only need n output rows (4× smaller than full capacity here); the
    # window lands in the ring via roll → blit → roll-back, all cheap
    # vector ops (see scatter_rows_dense for why not scatter).
    w0 = m.point_count % m.capacity
    sel_first, blk_written = row_select(offsets, new_valid, n)
    blk_pts = apply_row_select(sel_first, blk_written, new_points)
    blk_birth = apply_row_select(sel_first, blk_written, m.point_count + offsets)

    def blit(target, block, written_col):
        rolled = jnp.roll(target, -w0, axis=0)
        w = written_col.reshape((n,) + (1,) * (target.ndim - 1))
        head = jnp.where(w, block, rolled[:n])
        return jnp.roll(jnp.concatenate([head, rolled[n:]], axis=0), w0, axis=0)

    points = blit(m.points, blk_pts, blk_written)
    point_birth = blit(m.point_birth, blk_birth, blk_written)
    written = blit(m.point_valid & False, blk_written, blk_written)
    point_valid = m.point_valid | written
    # Recycled slots lose their old observations.
    obs_mask = m.obs_mask & ~written[None, :]
    n_new = jnp.sum(new_valid.astype(jnp.int32))
    return (
        m._replace(
            points=points,
            point_valid=point_valid,
            point_birth=point_birth,
            obs_mask=obs_mask,
            point_count=m.point_count + n_new,
        ),
        jnp.where(new_valid, slots, -1),
    )


@jax.jit
def add_observations(
    m: MapState,
    kf_slot: jax.Array,
    point_slots: jax.Array,
    uv: jax.Array,
    valid: jax.Array,
) -> MapState:
    """Record pixel observations of ``point_slots`` in keyframe ``kf_slot``.

    The per-point write becomes a dense row rebuild + one dynamic row
    update (single-index ``at[kf_slot]`` lowers to dynamic-update-slice,
    which is fast — only multi-index scatters are the trap).
    """
    ok = valid & (point_slots >= 0)
    new_uv, written = scatter_rows_dense(uv, point_slots, ok, m.capacity)
    ks = jnp.clip(kf_slot, 0, m.window - 1)
    row_uv = jnp.where(written[:, None], new_uv, m.obs_uv[ks])
    row_mask = m.obs_mask[ks] | written
    # kf_slot < 0 (disabled) must be a no-op.
    enabled = kf_slot >= 0
    row_uv = jnp.where(enabled, row_uv, m.obs_uv[ks])
    row_mask = jnp.where(enabled, row_mask, m.obs_mask[ks])
    return m._replace(
        obs_uv=m.obs_uv.at[ks].set(row_uv),
        obs_mask=m.obs_mask.at[ks].set(row_mask),
    )


class AssocState(NamedTuple):
    """Cross-frame landmark association carried between chunks.

    Maps each keypoint slot of the *last processed frame* to the map-point
    slot it re-observes (−1 = none).  ``birth`` guards against ring-slot
    recycling: an association is honoured only while the slot still holds
    the same allocation (``MapState.point_birth`` matches).
    """

    kp_to_point: jax.Array  # (K,) int32 — map slot per keypoint, −1 none
    kp_birth: jax.Array  # (K,) int32 — allocation id guard
    prev_kf_slot: jax.Array  # () int32 — window slot of last keyframe, −1
    prev_xy: jax.Array  # (K, 2) float32 — last frame's keypoint pixels


def empty_assoc(max_keypoints: int) -> AssocState:
    return AssocState(
        kp_to_point=jnp.full((max_keypoints,), -1, jnp.int32),
        kp_birth=jnp.full((max_keypoints,), -1, jnp.int32),
        prev_kf_slot=jnp.asarray(-1, jnp.int32),
        prev_xy=jnp.zeros((max_keypoints, 2), jnp.float32),
    )


@partial(jax.jit, static_argnames=("gate_px", "min_cand_depth"))
def update_map_chunk(
    m: MapState,
    assoc: AssocState,
    K: jax.Array,  # (3, 3) camera intrinsics (observation gating)
    frame_ids: jax.Array,  # (B,) int32
    kf_mask: jax.Array,  # (B,) bool — which frames become keyframes
    poses: jax.Array,  # (B, 4, 4) T_world_cam
    pose_ok: jax.Array,  # (B,) bool
    kps_xy: jax.Array,  # (B, K, 2)
    m_query: jax.Array,  # (B, M) int32 — match idx into previous frame kps
    m_train: jax.Array,  # (B, M) int32 — match idx into current frame kps
    m_valid: jax.Array,  # (B, M) bool
    points3d_cur: jax.Array,  # (B, M, 3) — current-camera-frame triangulations
    point_ok: jax.Array,  # (B, M) bool
    gate_px: float = 8.0,
    min_cand_depth: float = 0.2,
) -> tuple[MapState, AssocState]:
    """Fold one chunk of frames into the map with landmark re-association.

    One jitted dispatch per chunk (replacing the round-1 per-keyframe host
    loop).  Landmark identity is propagated through *every* frame's match
    indices — a keypoint matched to a keypoint that carried a map point
    inherits that point — so keyframes separated by non-keyframe frames
    still re-observe the same landmarks, giving BA multi-view constraints
    (the round-1 map gave every point exactly one observation).  New triangulations also get a second
    observation in the previous keyframe when the pair's query frame was
    one.  Reference intent: ``Map::insertMapPoint`` persistent landmarks
    (``include/slam/backend/map.hpp:9-21``).
    """

    def step(carry, xs):
        m, a = carry
        fid, is_kf, T_w, ok_pose, xy, q, t, mv, X_cur, ok_pt = xs
        enabled = is_kf & (ok_pose | (m.kf_count == 0))

        qc = jnp.maximum(q, 0)
        tc = jnp.maximum(t, 0)
        uv_cur = xy[tc]
        # --- association through the previous frame's keypoints -------------
        cand_slot = a.kp_to_point[qc]  # (M,)
        cand_birth = a.kp_birth[qc]
        alive = (
            mv
            & (cand_slot >= 0)
            & (m.point_birth[jnp.maximum(cand_slot, 0)] == cand_birth)
            & m.point_valid[jnp.maximum(cand_slot, 0)]
        )
        # Reprojection gate: a chained association is only trusted if the
        # landmark actually projects near the keypoint that claims to
        # re-observe it (chains through one bad match otherwise smuggle
        # hundreds-of-pixels outliers into BA).
        R_cw_g = jnp.swapaxes(T_w[:3, :3], 0, 1)
        Xc_cand = (
            m.points[jnp.maximum(cand_slot, 0)] - T_w[:3, 3][None, :]
        ) @ R_cw_g.T
        z_cand = Xc_cand[:, 2]
        pix = Xc_cand @ K.T
        uv_pred = pix[:, :2] / jnp.maximum(pix[:, 2:3], 1e-9)
        gate = (z_cand > min_cand_depth) & (
            jnp.sum((uv_pred - uv_cur) ** 2, axis=-1) < gate_px * gate_px
        )
        alive = alive & gate
        assoc_slot = jnp.where(alive, cand_slot, -1)

        # --- new landmarks: good triangulations with no association ---------
        R_w = T_w[:3, :3]
        X_world = (
            jnp.einsum("ij,mj->mi", R_w, X_cur, precision="highest")
            + T_w[:3, 3][None, :]
        )
        new_mask = ok_pt & (assoc_slot < 0) & enabled
        m2, new_slots = insert_points(m, X_world, new_mask)

        pt_slot = jnp.where(assoc_slot >= 0, assoc_slot, new_slots)  # (M,)

        # --- keyframe insertion + observations -------------------------------
        R_cw = jnp.swapaxes(R_w, 0, 1)
        m3, kf_slot = insert_keyframe(
            m2, fid, R_cw, -R_cw @ T_w[:3, 3], enabled
        )
        obs_ok = (alive | new_mask) & enabled
        m4 = add_observations(m3, jnp.maximum(kf_slot, 0), pt_slot, uv_cur, obs_ok)
        # second view for brand-new points: the pair's query frame, when it
        # was itself a keyframe still in the window (same reprojection gate)
        uv_prev = a.prev_xy[qc]
        pks = jnp.maximum(a.prev_kf_slot, 0)
        Xc_prev = X_world @ m4.kf_R[pks].T + m4.kf_t[pks][None, :]
        z_prev = Xc_prev[:, 2]
        pix_p = Xc_prev @ K.T
        uv_pred_p = pix_p[:, :2] / jnp.maximum(pix_p[:, 2:3], 1e-9)
        gate_p = (z_prev > min_cand_depth) & (
            jnp.sum((uv_pred_p - uv_prev) ** 2, axis=-1) < gate_px * gate_px
        )
        m5 = add_observations(
            m4,
            pks,
            new_slots,
            uv_prev,
            new_mask & (a.prev_kf_slot >= 0) & gate_p,
        )

        # --- propagate landmark identity to the current frame ----------------
        # Slot + birth share one writer-selection table (see row_select).
        k_cap = a.kp_to_point.shape[0]
        carry_ok = mv & (pt_slot >= 0) & (alive | (new_mask & enabled))
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
        return (m5, a2), None

    (m_out, a_out), _ = jax.lax.scan(
        step,
        (m, assoc),
        (
            frame_ids,
            kf_mask,
            poses,
            pose_ok,
            kps_xy,
            m_query,
            m_train,
            m_valid,
            points3d_cur,
            point_ok,
        ),
    )
    return m_out, a_out


# ---------------------------------------------------------------------------
# Chunk-batched map fold
# ---------------------------------------------------------------------------


def _compact_valid(valid: jax.Array, payloads: list[jax.Array], cap: int):
    """Gather the first ``cap`` valid entries (ascending index, order kept).

    Overflow (> cap valid entries) drops the highest-index ones — the same
    graceful-degradation contract as BA's ``active_points`` compaction.
    Returns (valid' (cap,), payloads' each (cap, ...)).
    """
    n = valid.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(valid, n - idx, 0)  # valid sort ascending-by-index
    _, order = jax.lax.top_k(key, min(cap, n))
    v = valid[order]
    return v, [p[order] for p in payloads]


def _scatter_rows_multi(
    slots: jax.Array,  # (M,) int32 target rows
    valid: jax.Array,  # (M,) bool
    payloads: list[jax.Array],  # each (M,) or (M, D)
    out_rows: int,
) -> tuple[jax.Array, list[jax.Array]]:
    """First-wins dense scatter of several payloads through ONE equality
    table (``scatter_rows_dense`` recomputes it per payload).  Float
    payloads ride the matrix units as a one-hot matmul; integer/bool payloads use
    the exact masked-max path.  Returns (written (out_rows,), rows list).
    """
    eff = jnp.where(valid, slots, -1)
    sel = eff[None, :] == jnp.arange(out_rows, dtype=slots.dtype)[:, None]
    written = jnp.any(sel, axis=1)
    first = jnp.argmax(sel, axis=1)
    sel_first = (
        jnp.arange(sel.shape[1], dtype=jnp.int32)[None, :] == first[:, None]
    ) & written[:, None]
    out = []
    sel_f32 = None
    for p in payloads:
        v2 = p[:, None] if p.ndim == 1 else p
        if jnp.issubdtype(p.dtype, jnp.integer) or p.dtype == jnp.bool_:
            vi = v2.astype(jnp.int32)
            rows = jnp.max(
                jnp.where(sel_first[:, :, None], vi[None, :, :], jnp.iinfo(jnp.int32).min),
                axis=1,
            )
            rows = jnp.where(written[:, None], rows, 0).astype(
                jnp.int32 if p.dtype == jnp.bool_ else p.dtype
            )
            if p.dtype == jnp.bool_:
                rows = rows.astype(bool)
        else:
            if sel_f32 is None:
                sel_f32 = sel_first.astype(jnp.float32)
            rows = jnp.matmul(sel_f32, v2.astype(jnp.float32), precision="highest").astype(
                v2.dtype
            )
        out.append(rows[:, 0] if p.ndim == 1 else rows)
    return written, out


@partial(
    jax.jit,
    static_argnames=("gate_px", "min_cand_depth", "obs_per_row", "new_per_frame"),
)
def update_map_chunk_batched(
    m: MapState,
    assoc: AssocState,
    K: jax.Array,
    frame_ids: jax.Array,
    kf_mask: jax.Array,
    poses: jax.Array,
    pose_ok: jax.Array,
    kps_xy: jax.Array,
    m_query: jax.Array,
    m_train: jax.Array,
    m_valid: jax.Array,
    points3d_cur: jax.Array,
    point_ok: jax.Array,
    gate_px: float = 8.0,
    min_cand_depth: float = 0.2,
    obs_per_row: int = 1024,
    new_per_frame: int = 512,
) -> tuple[MapState, AssocState]:
    """Chunk-batched equivalent of :func:`update_map_chunk`.

    The per-frame scan rebuilds (W, P) observation rows and ring-blits the
    point buffer **every frame**, yet only the final state survives the
    chunk: a B=16 chunk re-inserts every ring slot of a W=8 keyframe window
    at least once, so the first B−W frames' observation scatters are
    overwritten work (once the largest non-VO line of SLAM mode).  This version splits the fold:

      1. a **lean identity scan** over frames carrying only per-keypoint
         landmark identity (slot, allocation id, world position) — the
         sequential part of association — with small (K,)-shaped tables;
         liveness of a candidate slot is a closed form (allocations are
         sequential ring slots, so slot ``s`` holding allocation ``b``
         satisfies ``s ≡ b (mod P)`` and is recycled exactly when the
         global counter passes ``b + P``) instead of carried (P,) state;
      2. a **batched rebuild** of exactly the rows that survive: one
         staged ring blit for all of the chunk's new points, and one
         first-wins scatter per *final* window row (own observations +
         the successor frame's second-view observations in one table,
         later-allocation column clears applied in closed form).

    Capacity contracts (all hold with ≥3× margin at bench shapes, and
    overflow degrades gracefully — lowest-priority entries drop, exactly
    like BA's ``active_points``): ≤ ``new_per_frame`` new landmarks per
    frame, ≤ capacity ``P`` new landmarks per chunk, ≤ ``obs_per_row``
    observations per keyframe, window ≥ 2, and allocation counters below
    2²⁴ (the float32-exact matmul range; ~110k frames at 150 pts/frame —
    the same bound ``scatter_rows_dense`` documents).

    Equality with the scan oracle is asserted by
    ``tests/test_map_batched.py`` across multi-chunk runs with ring
    recycling, pose failures, and sparse keyframe masks.
    """
    B, M = m_query.shape
    P = m.capacity
    W = m.window
    Kp = assoc.kp_to_point.shape[0]
    if W < 2:
        raise ValueError("update_map_chunk_batched requires window >= 2")
    count0 = m.point_count
    init_birth = m.point_birth
    init_valid = m.point_valid
    init_points = m.points
    ncap = min(new_per_frame, M)

    # ---- phase 1: identity scan (small tables only) -------------------------
    kp_pos0 = init_points[jnp.maximum(assoc.kp_to_point, 0)]

    def step1(carry, xs):
        kp2p, kpb, kppos, prev_xy, count, kfc = carry
        fid, is_kf, T_w, ok_pose, xy, q, t, mv, X_cur, ok_pt = xs
        del fid
        enabled = is_kf & (ok_pose | (kfc == 0))
        qc = jnp.maximum(q, 0)
        tc = jnp.maximum(t, 0)
        uv_cur = xy[tc]
        cand_slot = kp2p[qc]
        cand_birth = kpb[qc]
        cand_pos = kppos[qc]
        # liveness: pre-chunk candidates must match the initial buffers;
        # any candidate dies when the allocation counter passes birth + P.
        scg = jnp.maximum(cand_slot, 0)
        pre = cand_birth < count0
        init_ok = (init_birth[scg] == cand_birth) & init_valid[scg]
        live = jnp.where(pre, init_ok, True) & (count <= cand_birth + P)
        # reprojection gate — same expression as the scan oracle
        R_cw_g = jnp.swapaxes(T_w[:3, :3], 0, 1)
        Xc_cand = (cand_pos - T_w[:3, 3][None, :]) @ R_cw_g.T
        pix = Xc_cand @ K.T
        uv_pred = pix[:, :2] / jnp.maximum(pix[:, 2:3], 1e-9)
        gate = (Xc_cand[:, 2] > min_cand_depth) & (
            jnp.sum((uv_pred - uv_cur) ** 2, axis=-1) < gate_px * gate_px
        )
        alive = mv & (cand_slot >= 0) & live & gate
        assoc_slot = jnp.where(alive, cand_slot, -1)

        R_w = T_w[:3, :3]
        X_world = (
            jnp.einsum("ij,mj->mi", R_w, X_cur, precision="highest")
            + T_w[:3, 3][None, :]
        )
        new_mask = ok_pt & (assoc_slot < 0) & enabled
        offs = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
        # graceful overflow: drop landmarks beyond the per-frame staging
        # capacity HERE so counters, ring slots, and observation writes all
        # agree about which points exist.
        new_mask = new_mask & (offs < ncap)
        alloc_id = count + offs
        new_slots = jnp.where(new_mask, alloc_id % P, -1)
        pt_slot = jnp.where(assoc_slot >= 0, assoc_slot, new_slots)
        obs_ok = (alive | new_mask) & enabled
        kf_slot = jnp.where(enabled, kfc % W, -1)
        uv_prev = prev_xy[qc]
        count2 = count + jnp.sum(new_mask.astype(jnp.int32))

        # this frame's new points, compacted by allocation offset (the
        # phase-2 staging block; also the recycling-alias lookup below)
        bval, (bpts,) = _compact_valid(new_mask, [X_world], ncap)

        # propagate identity to the current frame's keypoints (one table).
        # Scan-oracle quirk replicated exactly: the scan gathers birth (and
        # reads positions next frame) from the post-insertion map, so an
        # ALIVE association whose slot is recycled by one of THIS frame's
        # allocations inherits the new occupant's birth id and position
        # (and then dies at the next frame's gate/birth check).
        a_slot = count + jnp.mod(cand_slot - count, P)
        recycled_now = alive & (a_slot < count2)
        occ_pos = bpts[jnp.clip(a_slot - count, 0, ncap - 1)]
        carry_ok = mv & (pt_slot >= 0) & (alive | new_mask)
        birth_val = jnp.where(
            alive, jnp.where(recycled_now, a_slot, cand_birth), alloc_id
        )
        pos_val = jnp.where(
            alive[:, None],
            jnp.where(recycled_now[:, None], occ_pos, cand_pos),
            X_world,
        )
        written_k, (srow, brow, prow) = _scatter_rows_multi(
            tc, carry_ok, [pt_slot, birth_val, pos_val], Kp
        )
        kp2p2 = jnp.where(written_k, srow, -1)
        kpb2 = jnp.where(written_k, brow, -1)
        kppos2 = jnp.where(written_k[:, None], prow, 0.0)
        kfc2 = kfc + enabled.astype(jnp.int32)
        ys = (enabled, kf_slot, count, pt_slot, obs_ok, new_mask, X_world,
              uv_cur, uv_prev, bval, bpts)
        return (kp2p2, kpb2, kppos2, xy, count2, kfc2), ys

    carry0 = (
        assoc.kp_to_point, assoc.kp_birth, kp_pos0, assoc.prev_xy,
        count0, m.kf_count,
    )
    xs = (frame_ids, kf_mask, poses, pose_ok, kps_xy, m_query, m_train,
          m_valid, points3d_cur, point_ok)
    (kp2p_f, kpb_f, _, prev_xy_f, count_final, kfc_final), ys = jax.lax.scan(
        step1, carry0, xs
    )
    (enabled_B, kf_slot_B, count_start_B, pt_slot_B, obs_ok_B, new_mask_B,
     X_world_B, uv_cur_B, uv_prev_B, bval, bpts) = ys
    n_new_B = jnp.sum(new_mask_B.astype(jnp.int32), axis=1)
    count_after_B = count_start_B + n_new_B
    offs_B = jnp.cumsum(new_mask_B.astype(jnp.int32), axis=1) - 1
    new_slots_B = jnp.where(
        new_mask_B, (count_start_B[:, None] + offs_B) % P, -1
    )

    # ---- phase 2a: one staged ring blit for the chunk's new points ----------
    s_total = int(min(B * ncap, P))
    stage_pts = jnp.zeros((s_total + ncap, 3), jnp.float32)
    stage_w = jnp.zeros((s_total + ncap,), bool)

    def place(f, acc):
        sp, sw = acc
        o = count_start_B[f] - count0
        return (
            jax.lax.dynamic_update_slice(sp, bpts[f], (o, 0)),
            jax.lax.dynamic_update_slice(sw, bval[f], (o,)),
        )

    stage_pts, stage_w = jax.lax.fori_loop(0, B, place, (stage_pts, stage_w))
    stage_pts = stage_pts[:s_total]
    stage_w = stage_w[:s_total]
    stage_birth = jnp.where(
        stage_w, count0 + jnp.arange(s_total, dtype=jnp.int32), 0
    )
    w0 = count0 % P

    def blit(target, block):
        rolled = jnp.roll(target, -w0, axis=0)
        wcol = stage_w.reshape((s_total,) + (1,) * (target.ndim - 1))
        head = jnp.where(wcol, block, rolled[:s_total])
        return jnp.roll(
            jnp.concatenate([head, rolled[s_total:]], axis=0), w0, axis=0
        )

    points_f = blit(m.points, stage_pts)
    birth_f = blit(m.point_birth, stage_birth)
    written_ring = blit(jnp.zeros((P,), bool), stage_w)
    point_valid_f = m.point_valid | written_ring

    # ---- phase 2b: final keyframe ring rows ---------------------------------
    f_idx = jnp.arange(B, dtype=jnp.int32)
    hits = (kf_slot_B[None, :] == jnp.arange(W, dtype=jnp.int32)[:, None]) & (
        enabled_B[None, :]
    )
    fw = jnp.max(jnp.where(hits, f_idx[None, :], -1), axis=1)  # (W,)
    in_chunk = fw >= 0
    fwc = jnp.maximum(fw, 0)
    R_w_rows = poses[fwc, :3, :3]
    R_cw_rows = jnp.swapaxes(R_w_rows, -1, -2)
    t_cw_rows = -jnp.einsum("wij,wj->wi", R_cw_rows, poses[fwc, :3, 3])
    sel3 = in_chunk[:, None, None]
    kf_R_f = jnp.where(sel3, R_cw_rows, m.kf_R)
    kf_t_f = jnp.where(in_chunk[:, None], t_cw_rows, m.kf_t)
    kf_id_f = jnp.where(in_chunk, frame_ids[fwc], m.kf_id)
    kf_valid_f = m.kf_valid | in_chunk

    # ---- phase 2c: observation rows -----------------------------------------
    col = jnp.arange(P, dtype=jnp.int32)

    def cleared_from(start):
        # column c is recycled iff an allocation in [start, count_final)
        # lands on it: the first one at/after start is start + ((c-start)%P)
        return (start + jnp.mod(col - start, P)) < count_final

    cleared_pre = cleared_from(count0)

    # frame 0's second-view writes into the carried-over previous keyframe
    # row (pre-chunk pose); they survive only if that row is never
    # re-inserted this chunk.
    r0 = assoc.prev_kf_slot
    r0c = jnp.maximum(r0, 0)
    Xc0 = X_world_B[0] @ m.kf_R[r0c].T + m.kf_t[r0c][None, :]
    pix0 = Xc0 @ K.T
    uvp0 = pix0[:, :2] / jnp.maximum(pix0[:, 2:3], 1e-9)
    gate0 = (Xc0[:, 2] > min_cand_depth) & (
        jnp.sum((uvp0 - uv_prev_B[0]) ** 2, axis=-1) < gate_px * gate_px
    )
    sec0_ok = new_mask_B[0] & (r0 >= 0) & gate0
    sec0_written, (sec0_uv,) = _scatter_rows_multi(
        new_slots_B[0], sec0_ok, [uv_prev_B[0]], P
    )

    def obs_row(w):
        f_w = fw[w]
        f_wc = fwc[w]
        own_slot = pt_slot_B[f_wc]
        own_uv = uv_cur_B[f_wc]
        own_ok = obs_ok_B[f_wc] & in_chunk[w]
        f2 = f_w + 1
        has2 = in_chunk[w] & (f2 < B)
        f2c = jnp.minimum(jnp.maximum(f2, 0), B - 1)
        # second view: the successor frame's NEW points, gated against this
        # row's (just-inserted) pose — scan semantics: only the immediate
        # next frame can hold prev_kf_slot == w.
        Xc2 = X_world_B[f2c] @ R_cw_rows[w].T + t_cw_rows[w][None, :]
        pix2 = Xc2 @ K.T
        uvp2 = pix2[:, :2] / jnp.maximum(pix2[:, 2:3], 1e-9)
        gate2 = (Xc2[:, 2] > min_cand_depth) & (
            jnp.sum((uvp2 - uv_prev_B[f2c]) ** 2, axis=-1) < gate_px * gate_px
        )
        sec_ok = new_mask_B[f2c] & has2 & gate2
        # second first: a later add_observations call overwrites earlier
        # columns in the scan, so second-view entries take precedence.
        slots_c = jnp.concatenate([new_slots_B[f2c], own_slot])
        uv_c = jnp.concatenate([uv_prev_B[f2c], own_uv])
        ok_c = jnp.concatenate([sec_ok, own_ok])
        is_sec = jnp.arange(2 * M, dtype=jnp.int32) < M
        cv, (cs, cuv, csec) = _compact_valid(
            ok_c, [slots_c, uv_c, is_sec], min(obs_per_row, 2 * M)
        )
        row_written, (uv_rows, sec_rows) = _scatter_rows_multi(
            cs, cv, [cuv, csec], P
        )
        cleared_own = cleared_from(count_after_B[f_wc])
        mask_in = row_written & (sec_rows | ~cleared_own)
        uv_in = jnp.where(row_written[:, None], uv_rows, 0.0)
        # pre-chunk row: keep content minus recycled columns, plus frame 0's
        # second-view writes when this is the carried previous keyframe row.
        is_r0 = (w == r0) & ~in_chunk[w]
        add0 = sec0_written & is_r0
        mask_pre = (m.obs_mask[w] & ~cleared_pre) | add0
        uv_pre = jnp.where(add0[:, None], sec0_uv, m.obs_uv[w])
        mask_f = jnp.where(in_chunk[w], mask_in, mask_pre)
        uv_f = jnp.where(in_chunk[w], uv_in, uv_pre)
        return mask_f, uv_f

    obs_mask_f, obs_uv_f = jax.vmap(obs_row)(jnp.arange(W, dtype=jnp.int32))

    m_out = MapState(
        kf_R=kf_R_f,
        kf_t=kf_t_f,
        kf_id=kf_id_f,
        kf_valid=kf_valid_f,
        points=points_f,
        point_valid=point_valid_f,
        point_birth=birth_f,
        obs_uv=obs_uv_f,
        obs_mask=obs_mask_f,
        kf_count=kfc_final,
        point_count=count_final,
    )
    a_out = AssocState(
        kp_to_point=kp2p_f,
        kp_birth=kpb_f,
        prev_kf_slot=jnp.where(
            enabled_B[B - 1], kf_slot_B[B - 1], jnp.asarray(-1, jnp.int32)
        ),
        prev_xy=prev_xy_f,
    )
    return m_out, a_out
