"""Scalar NumPy oracles for the frontend numerics.

These are *independent test oracles* implementing the same algorithm
semantics as the reference C++ (cited per function), written in
straightforward NumPy/Python.  They intentionally favour clarity over speed
and are used by the golden tests to validate the vectorised JAX paths.
"""

from __future__ import annotations

import numpy as np

CIRCLE_OFFSETS = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]


def is_fast_corner(img: np.ndarray, x: int, y: int, threshold: int, contiguous: int) -> bool:
    """Semantics of reference feature_detector.cpp:70-145 (two-stage test)."""
    c = int(img[y, x])
    # Stage 1: cardinals {0, 8}
    brighter = darker = 0
    for idx in (0, 8):
        dx, dy = CIRCLE_OFFSETS[idx]
        n = int(img[y + dy, x + dx])
        if n > c + threshold:
            brighter += 1
        elif n < c - threshold:
            darker += 1
    if brighter == 0 and darker == 0:
        return False
    # Stage 2: cardinals {4, 12} added to the same counters
    for idx in (4, 12):
        dx, dy = CIRCLE_OFFSETS[idx]
        n = int(img[y + dy, x + dx])
        if n > c + threshold:
            brighter += 1
        elif n < c - threshold:
            darker += 1
    if brighter < 3 and darker < 3:
        return False
    # Full 32-iteration wrap-around segment test
    brighter = darker = 0
    for i in range(32):
        dx, dy = CIRCLE_OFFSETS[i % 16]
        n = int(img[y + dy, x + dx])
        if n > c + threshold:
            brighter += 1
            darker = 0
        elif n < c - threshold:
            darker += 1
            brighter = 0
        else:
            brighter = darker = 0
        if brighter >= contiguous or darker >= contiguous:
            return True
    return False


def detect_fast(img: np.ndarray, threshold: int, contiguous: int) -> list[tuple[int, int]]:
    """Full-image scan with border 3 (reference feature_detector.cpp:56-68)."""
    h, w = img.shape
    out = []
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            if is_fast_corner(img, x, y, threshold, contiguous):
                out.append((x, y))
    return out


def fast_score(img: np.ndarray, x: int, y: int) -> float:
    """SAD of 16 circle pixels vs center (reference :190-203)."""
    c = int(img[y, x])
    return float(sum(abs(int(img[y + dy, x + dx]) - c) for dx, dy in CIRCLE_OFFSETS))


def greedy_nms(
    img: np.ndarray, keypoints: list[tuple[int, int]], window: int
) -> list[tuple[int, int, float]]:
    """Greedy sorted NMS (reference :147-188) — the sequential original."""
    scored = [(x, y, fast_score(img, x, y)) for (x, y) in keypoints]
    scored.sort(key=lambda kp: -kp[2])
    suppressed = [False] * len(scored)
    kept = []
    for i, (xi, yi, si) in enumerate(scored):
        if suppressed[i]:
            continue
        kept.append((xi, yi, si))
        for j in range(i + 1, len(scored)):
            if suppressed[j]:
                continue
            xj, yj, _ = scored[j]
            if ((xi - xj) ** 2 + (yi - yj) ** 2) ** 0.5 < float(window):
                suppressed[j] = True
    return kept


def gaussian_blur(img: np.ndarray, kernel_size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """Interior conv + borders copied from the original (reference :315-364)."""
    half = kernel_size // 2
    ii, jj = np.meshgrid(
        np.arange(-half, half + 1), np.arange(-half, half + 1), indexing="ij"
    )
    kernel = np.exp(-(ii**2 + jj**2) / (2 * sigma * sigma))
    kernel /= kernel.sum()
    h, w = img.shape
    out = np.zeros_like(img)
    f = img.astype(np.float64)
    for y in range(half, h - half):
        for x in range(half, w - half):
            patch = f[y - half : y + half + 1, x - half : x + half + 1]
            out[y, x] = np.uint8(np.floor((patch * kernel).sum() + 0.5))
    out[:half, :] = img[:half, :]
    out[h - half :, :] = img[h - half :, :]
    out[:, :half] = img[:, :half]
    out[:, w - half :] = img[:, w - half :]
    return out


def orientation(img: np.ndarray, x: int, y: int, patch_size: int) -> float:
    """Intensity centroid in degrees; 0 if clipped (reference :205-231)."""
    radius = patch_size // 2
    h, w = img.shape
    if x - radius < 0 or x + radius >= w or y - radius < 0 or y + radius >= h:
        return 0.0
    m01 = m10 = 0.0
    for v in range(-radius, radius + 1):
        for u in range(-radius, radius + 1):
            if u * u + v * v <= radius * radius:
                i = float(img[y + v, x + u])
                m01 += v * i
                m10 += u * i
    return float(np.degrees(np.arctan2(m01, m10)))


def brief_descriptor(
    img: np.ndarray,
    x: int,
    y: int,
    angle_deg: float,
    pattern: list[tuple[tuple[int, int], tuple[int, int]]],
    num_pairs: int,
    patch_size: int,
) -> np.ndarray:
    """Steered BRIEF with skip-without-advancing (reference :233-284)."""
    desc_size = num_pairs // 8
    desc = np.zeros(desc_size, dtype=np.uint8)
    h, w = img.shape
    half = patch_size // 2
    if x - half < 0 or x + half >= w or y - half < 0 or y + half >= h:
        return desc
    a = np.radians(angle_deg)
    ca, sa = float(np.cos(a)), float(np.sin(a))
    bit_index = 0
    for (p1, p2) in pattern:
        if bit_index >= desc_size * 8:
            break
        x1 = int(p1[0] * ca - p1[1] * sa) + x
        y1 = int(p1[0] * sa + p1[1] * ca) + y
        x2 = int(p2[0] * ca - p2[1] * sa) + x
        y2 = int(p2[0] * sa + p2[1] * ca) + y
        if 0 <= x1 < w and 0 <= y1 < h and 0 <= x2 < w and 0 <= y2 < h:
            if img[y1, x1] < img[y2, x2]:
                desc[bit_index // 8] |= 1 << (bit_index % 8)
            bit_index += 1
    return desc


def match_hamming(
    desc1: np.ndarray,
    desc2: np.ndarray,
    kps1: list[tuple[float, float]] | None,
    kps2: list[tuple[float, float]] | None,
    ratio_threshold: float,
    use_ratio_test: bool,
    max_jump_radius: float = 500.0,
) -> list[tuple[int, int, float]]:
    """Best/second-best with jump penalty + ratio test
    (reference feature_matcher.cpp:143-189)."""
    out = []
    use_kp = kps1 is not None and kps2 is not None and len(kps1) and len(kps2)
    for i in range(desc1.shape[0]):
        best = second = np.iinfo(np.int32).max
        best_j = -1
        for j in range(desc2.shape[0]):
            d = int(
                bin(
                    int.from_bytes(desc1[i].tobytes(), "big")
                    ^ int.from_bytes(desc2[j].tobytes(), "big")
                ).count("1")
            )
            if use_kp:
                dx = kps1[i][0] - kps2[j][0]
                dy = kps1[i][1] - kps2[j][1]
                dist_px = (dx * dx + dy * dy) ** 0.5
                if dist_px > max_jump_radius:
                    d = int(d * (1.0 + dist_px / max_jump_radius))
            if d < best:
                second = best
                best = d
                best_j = j
            elif d < second:
                second = d
        good = True
        if use_ratio_test and best >= ratio_threshold * second:
            good = False
        if good and best_j != -1:
            out.append((i, best_j, float(best)))
    return out


# --------------------------------------------------------------------------
# Two-view pose: reference numerics (float64, OpenCV RANSAC essential)
# --------------------------------------------------------------------------


def decompose_essential_ref(E: np.ndarray):
    """E → (R1, R2, t), reference ``simple_pose_recover.cpp:6-18``.

    float64 SVD; rotations det-corrected by negating R (not U); t = U[:, 2].
    """
    u, _, vt = np.linalg.svd(E.astype(np.float64))
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    if np.linalg.det(R1) < 0:
        R1 = -R1
    if np.linalg.det(R2) < 0:
        R2 = -R2
    return R1, R2, u[:, 2]


def simple_recover_pose_ref(
    E: np.ndarray,
    pts1_norm: np.ndarray,
    pts2_norm: np.ndarray,
    K: np.ndarray,
    emulate_k_quirk: bool = False,
):
    """Cheirality-voted pose recovery, reference ``simple_pose_recover.cpp:35-97``.

    The per-point 4×4 DLT SVDs (``triangulateSimple``, ``:21-32``) are
    batched with ``np.linalg.svd`` (identical LAPACK results).

    The reference applies K to the *already-normalised* points (``:61-65``).
    Measured on the KITTI fixtures, that quirk makes the vote degenerate —
    every point votes for one arbitrary candidate (e.g. [0, 53, 0, 0] where
    the intended-geometry vote is [0, 3, 0, 50]) and the translation sign
    flips from pair to pair.  The reference's own test would not catch this
    (it only warns below a 75% front-of-camera ratio, which the degenerate
    vote trivially exceeds).  The oracle therefore defaults to the
    *intended* numerics (identity K in the vote, matching
    ``cv::recoverPose``); pass ``emulate_k_quirk=True`` to reproduce the
    reference verbatim.
    """
    R1, R2, t = decompose_essential_ref(E)
    if not emulate_k_quirk:
        K = np.eye(3)
    P0 = np.eye(3, 4)
    Ps = [
        np.hstack([R1, t[:, None]]),
        np.hstack([R2, t[:, None]]),
        np.hstack([R1, -t[:, None]]),
        np.hstack([R2, -t[:, None]]),
    ]
    KP0 = K @ P0
    KPs = np.stack([K @ P for P in Ps])  # (4, 3, 4)

    x1, y1 = pts1_norm[:, 0], pts1_norm[:, 1]  # (M,)
    x2, y2 = pts2_norm[:, 0], pts2_norm[:, 1]
    rows01 = np.stack(
        [
            x1[:, None] * KP0[2] - KP0[0],
            y1[:, None] * KP0[2] - KP0[1],
        ],
        axis=1,
    )  # (M, 2, 4)
    best, max_front = 0, -1
    for i in range(4):
        rows23 = np.stack(
            [
                x2[:, None] * KPs[i][2] - KPs[i][0],
                y2[:, None] * KPs[i][2] - KPs[i][1],
            ],
            axis=1,
        )
        A = np.concatenate([rows01, rows23], axis=1)  # (M, 4, 4)
        _, _, vt = np.linalg.svd(A)
        X = vt[:, 3, :]  # (M, 4)
        X = X / X[:, 3:4]
        z1 = X[:, 2]
        z2 = X @ KPs[i][2]
        front = int(((z1 > 0) & (z2 > 0)).sum())
        if front > max_front:
            max_front = front
            best = i
    Rb = [R1, R2, R1, R2][best]
    tb = t if best < 2 else -t
    return Rb, tb


def estimate_pose_ref(pts1: np.ndarray, pts2: np.ndarray, K: np.ndarray):
    """Reference two-view pose flow (``pose_estimator.cpp:18-67``).

    ``cv::findEssentialMat(..., RANSAC)`` with OpenCV defaults (0.999
    confidence, 1.0 px threshold), K-normalisation, then
    ``simpleRecoverPose``.  Returns (R, t) with ``x2 ~ R x1 + t`` in
    camera-2 coordinates, or None on the reference's silent-return gates
    (< 8 matches / empty E).
    """
    import cv2

    if len(pts1) < 8:
        return None
    E, _ = cv2.findEssentialMat(
        pts1.astype(np.float64), pts2.astype(np.float64), K, cv2.RANSAC
    )
    if E is None or E.shape != (3, 3):
        return None
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    n1 = np.stack([(pts1[:, 0] - cx) / fx, (pts1[:, 1] - cy) / fy], axis=1)
    n2 = np.stack([(pts2[:, 0] - cx) / fx, (pts2[:, 1] - cy) / fy], axis=1)
    return simple_recover_pose_ref(E, n1, n2, K)
