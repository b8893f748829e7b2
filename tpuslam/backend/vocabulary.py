"""Binary visual vocabulary: bag-of-words for place recognition.

The reference uses an fbow vocabulary loaded from ``orb_mur.fbow``
(``loop_closure.cpp:22-27``) — a blob absent from this mount
(``.MISSING_LARGE_BLOBS``), so SURVEY §7 step 6 calls for a from-scratch,
accelerator-friendly replacement: a flat k-word vocabulary trained by binary k-means
over BRIEF descriptors, TF-IDF weighting, and similarity scoring as one
matmul over L2-normalised BoW vectors (score ∈ [0, 1], replacing fbow's
BoWVector::score with the same gating semantics).

Training runs as jitted JAX (Hamming assignment via the same bit-matmul
the matcher uses; centroid update = bitwise majority vote).  Vocabularies
serialise to ``.npz``.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.common.hamming import hamming_matrix, unpack_bits


def _pack_bits(bits: jax.Array) -> jax.Array:
    """(..., 8B) {0,1} → (..., B) uint8, LSB-first (inverse of unpack_bits)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    weights = (1 << jnp.arange(8, dtype=jnp.int32)).astype(jnp.uint8)
    return jnp.sum(b.astype(jnp.uint8) * weights, axis=-1, dtype=jnp.uint8)


def train_vocabulary(
    descriptors: np.ndarray,
    num_words: int = 256,
    iters: int = 10,
    seed: int = 0,
) -> np.ndarray:
    """Binary k-means over (N, B) uint8 descriptors → (num_words, B) uint8.

    Assignment: nearest centroid by Hamming distance (bit-matmul).
    Update: per-bit majority vote of assigned descriptors.  Empty clusters
    are reseeded from the descriptors farthest from their centroid.
    """
    rng = np.random.default_rng(seed)
    desc = jnp.asarray(descriptors, jnp.uint8)
    n = desc.shape[0]
    if n < num_words:
        raise ValueError(f"Need at least {num_words} descriptors, got {n}.")
    init = rng.choice(n, num_words, replace=False)
    centroids = desc[jnp.asarray(init)]

    bits = unpack_bits(desc).astype(jnp.float32)  # (N, 8B)

    @jax.jit
    def step(centroids):
        d = hamming_matrix(desc, centroids)  # (N, W)
        assign = jnp.argmin(d, axis=1)  # (N,)
        min_d = jnp.min(d, axis=1)
        # Majority vote per cluster: mean of bits > 0.5.
        onehot = jax.nn.one_hot(assign, num_words, dtype=jnp.float32)  # (N, W)
        counts = jnp.sum(onehot, axis=0)  # (W,)
        sums = onehot.T @ bits  # (W, 8B)
        mean = sums / jnp.maximum(counts[:, None], 1.0)
        new_bits = mean > 0.5
        new_centroids = _pack_bits(new_bits)
        # Keep old centroid for empty clusters (reseeded on host below).
        new_centroids = jnp.where(
            counts[:, None] > 0, new_centroids, centroids
        )
        return new_centroids, counts, min_d

    for _ in range(iters):
        centroids, counts, min_d = step(centroids)
        empty = np.asarray(counts) == 0
        if empty.any():
            far = np.argsort(-np.asarray(min_d))[: int(empty.sum())]
            cnp = np.array(centroids)  # writable copy
            cnp[np.nonzero(empty)[0]] = np.asarray(desc)[far]
            centroids = jnp.asarray(cnp)
    return np.asarray(centroids)


def train_vocabulary_tree(
    descriptors: np.ndarray,
    branching: tuple[int, int] = (64, 64),
    iters: int = 10,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Two-level tree k-means: k1 coarse words, k2 children each.

    The reference's fbow vocabulary is a k-ary tree over ~1M leaves
    (``loop_closure.cpp:22-27`` loads ``orb_mur.fbow``); a flat vocabulary
    cannot reach that scale because assignment costs O(K·W) Hamming
    distances per frame.  The tree form costs O(K·(k1+k2)) — at (64, 64)
    that is 32× less compute than a flat 4096 for the same leaf count —
    at the price of fbow's own approximation (a descriptor is quantised
    within its coarse cell only).  Returns ``(coarse (k1, B) uint8,
    leaves (k1·k2, B) uint8)`` with leaf ``c·k2 + j`` = child j of coarse
    word c.
    """
    k1, k2 = branching
    descriptors = np.asarray(descriptors, np.uint8)
    coarse = train_vocabulary(descriptors, k1, iters, seed)
    d = np.asarray(
        hamming_matrix(jnp.asarray(descriptors), jnp.asarray(coarse))
    )
    a1 = d.argmin(axis=1)
    rng = np.random.default_rng(seed + 1)
    B = descriptors.shape[1]
    leaves = np.zeros((k1 * k2, B), np.uint8)
    for c in range(k1):
        sub = descriptors[a1 == c]
        if len(sub) >= k2:
            leaves[c * k2 : (c + 1) * k2] = train_vocabulary(
                sub, k2, iters, seed + 2 + c
            )
        elif len(sub) > 0:
            # Thin cell: every member becomes a leaf; remaining slots
            # duplicate members (duplicates are harmless — argmin picks the
            # first, and IDF sees whatever actually matches).
            pad = sub[rng.integers(0, len(sub), k2 - len(sub))]
            leaves[c * k2 : (c + 1) * k2] = np.concatenate([sub, pad])
        else:
            leaves[c * k2 : (c + 1) * k2] = coarse[c]
    return coarse, leaves


class Vocabulary:
    """Trained vocabulary + IDF weights; ``transform`` and scoring are jitted.

    Flat form: ``centroids`` (W, B), one Hamming argmin per descriptor.
    Tree form (``coarse`` given): fbow-style two-level quantisation —
    coarse argmin over k1 words, then argmin over that word's k2 children;
    ``centroids`` holds the k1·k2 leaves.  BoW vectors, DB scoring, IDF
    and every consumer downstream are identical in both forms (only
    ``transform``'s assignment differs).
    """

    def __init__(
        self,
        centroids: np.ndarray,
        idf: np.ndarray | None = None,
        coarse: np.ndarray | None = None,
    ):
        self.centroids = jnp.asarray(centroids, jnp.uint8)  # (W, B)
        w = centroids.shape[0]
        self.coarse = None if coarse is None else jnp.asarray(coarse, jnp.uint8)
        if self.coarse is not None and w % self.coarse.shape[0]:
            raise ValueError(
                f"leaf count {w} not a multiple of coarse count "
                f"{self.coarse.shape[0]}"
            )
        self.idf = jnp.asarray(
            idf if idf is not None else np.ones(w), jnp.float32
        )

    @property
    def num_words(self) -> int:
        return int(self.centroids.shape[0])

    def __len__(self) -> int:  # reference checks vocabulary.size() != 0
        return self.num_words

    # --- persistence -----------------------------------------------------------
    def save(self, path: str | Path) -> None:
        arrays = dict(
            centroids=np.asarray(self.centroids), idf=np.asarray(self.idf)
        )
        if self.coarse is not None:
            arrays["coarse"] = np.asarray(self.coarse)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str | Path) -> "Vocabulary":
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(f"Vocabulary not found at path: {path}")
        data = np.load(path)
        if data["centroids"].size == 0:
            raise ValueError(f"Vocabulary is empty at path: {path}")
        return cls(
            data["centroids"], data["idf"],
            coarse=data["coarse"] if "coarse" in data else None,
        )

    @classmethod
    def fit(
        cls,
        descriptors: np.ndarray | list[np.ndarray],
        num_words: int = 256,
        iters: int = 10,
        seed: int = 0,
        branching: tuple[int, int] | None = None,
    ) -> "Vocabulary":
        """Train centroids and IDF weights from a descriptor corpus.

        Pass a list of per-image descriptor arrays to get per-image IDF
        (each image is one document); a single array is treated as one
        document per 500 descriptors.  ``branching=(k1, k2)`` trains the
        hierarchical (fbow-style) form with k1·k2 leaves instead of a flat
        ``num_words``.
        """
        if isinstance(descriptors, np.ndarray):
            docs = [
                descriptors[i : i + 500] for i in range(0, len(descriptors), 500)
            ]
        else:
            docs = [d for d in descriptors if len(d)]
        all_desc = np.concatenate(docs)
        if branching is not None:
            coarse, centroids = train_vocabulary_tree(
                all_desc, branching, iters, seed
            )
            vocab = cls(centroids, coarse=coarse)
        else:
            centroids = train_vocabulary(all_desc, num_words, iters, seed)
            vocab = cls(centroids)
        occurrence = np.zeros(vocab.num_words)
        for doc in docs:
            leaves = np.asarray(
                vocab.assign(jnp.asarray(doc, jnp.uint8))
            )
            occurrence[np.unique(leaves)] += 1
        idf = np.log((len(docs) + 1) / (occurrence + 1)) + 1.0
        vocab.idf = jnp.asarray(idf, jnp.float32)
        return vocab

    # --- transform / scoring ----------------------------------------------------
    def assign(self, descriptors: jax.Array) -> jax.Array:
        """(K, B) uint8 → (K,) int32 word/leaf assignment."""
        if self.coarse is None:
            return jnp.argmin(hamming_matrix(descriptors, self.centroids), axis=1)
        k1 = self.coarse.shape[0]
        k2 = self.centroids.shape[0] // k1
        return _assign_tree(
            descriptors, self.coarse,
            self.centroids.reshape(k1, k2, self.centroids.shape[1]),
        )

    def transform(self, descriptors: jax.Array, valid: jax.Array | None = None) -> jax.Array:
        """(K, B) uint8 (+ optional (K,) mask) → (W,) L2-normalised TF-IDF BoW.

        The analog of ``fbow::Vocabulary::transform``
        (``loop_closure.cpp:102``); empty input → zero vector (scores 0,
        mirroring the empty-BoW gate at ``loop_closure.cpp:122-124``).
        """
        if self.coarse is None:
            return _transform(descriptors, valid, self.centroids, self.idf)
        k1 = self.coarse.shape[0]
        k2 = self.centroids.shape[0] // k1
        return _transform_tree(
            descriptors, valid, self.coarse,
            self.centroids.reshape(k1, k2, self.centroids.shape[1]),
            self.idf,
        )

    @staticmethod
    def score(bow1: jax.Array, bow2: jax.Array) -> jax.Array:
        """Cosine similarity of BoW vectors (..., W) — batched matmul."""
        return jnp.sum(bow1 * bow2, axis=-1)


@jax.jit
def _transform(descriptors, valid, centroids, idf):
    d = hamming_matrix(descriptors, centroids)  # (K, W)
    assign = jnp.argmin(d, axis=1)
    return _bow_from_assign(assign, valid, centroids.shape[0], idf)


@jax.jit
def _assign_tree(descriptors, coarse, leaves_r):
    """Two-level quantisation: (K, B) uint8 → (K,) int32 leaf ids.

    Coarse assignment is one bit-matmul over k1 words; the child
    assignment gathers each descriptor's (k2, B) child block and runs
    XOR+popcount on the VPU (k2 is small, the gather is per-descriptor so
    there is no shared matmul shape).
    """
    d1 = hamming_matrix(descriptors, coarse)  # (K, k1)
    a1 = jnp.argmin(d1, axis=1)  # (K,)
    children = leaves_r[a1]  # (K, k2, B)
    x = jnp.bitwise_xor(descriptors[:, None, :], children)
    d2 = jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)
    a2 = jnp.argmin(d2, axis=1)
    return a1 * leaves_r.shape[1] + a2


@jax.jit
def _transform_tree(descriptors, valid, coarse, leaves_r, idf):
    assign = _assign_tree(descriptors, coarse, leaves_r)
    W = leaves_r.shape[0] * leaves_r.shape[1]
    return _bow_from_assign(assign, valid, W, idf)


def _bow_from_assign(assign, valid, num_words, idf):
    if valid is None:
        valid = jnp.ones(assign.shape[0], bool)
    onehot = jax.nn.one_hot(assign, num_words, dtype=jnp.float32)
    tf = jnp.sum(onehot * valid[:, None].astype(jnp.float32), axis=0)
    v = tf * idf
    norm = jnp.linalg.norm(v)
    return jnp.where(norm > 0, v / jnp.maximum(norm, 1e-12), v)
