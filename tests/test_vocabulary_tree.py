"""Hierarchical (two-level tree) vocabulary: training, transform, persistence.

The reference's fbow vocabulary is a k-ary tree (``loop_closure.cpp:22-27``
loads ``orb_mur.fbow``); this is the JAX equivalent
(``tpuslam/backend/vocabulary.py::train_vocabulary_tree``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

from tpuslam.backend.vocabulary import (
    Vocabulary,
    train_vocabulary_tree,
)
from tpuslam.common.hamming import hamming_matrix


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    # 8 well-separated "places", 100 noisy descriptors each
    places = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    descs = []
    for p in places:
        base = np.repeat(p[None], 100, axis=0)
        flips = rng.integers(0, 256, base.shape, dtype=np.uint8) & rng.integers(
            0, 2, base.shape, dtype=np.uint8
        )  # sparse bit noise
        descs.append(base ^ (flips & rng.integers(0, 4, base.shape, dtype=np.uint8)))
    return np.concatenate(descs), places


def test_tree_shapes_and_leaf_layout(corpus):
    desc, _ = corpus
    coarse, leaves = train_vocabulary_tree(desc, branching=(4, 8), iters=4)
    assert coarse.shape == (4, 16)
    assert leaves.shape == (32, 16)


def test_tree_assignment_respects_coarse_cell(corpus):
    desc, _ = corpus
    coarse, leaves = train_vocabulary_tree(desc, branching=(4, 8), iters=4)
    vocab = Vocabulary(leaves, coarse=coarse)
    d = jnp.asarray(desc[:50])
    leaf = np.asarray(vocab.assign(d))
    # each leaf id must fall inside the block of its coarse assignment
    a1 = np.asarray(jnp.argmin(hamming_matrix(d, jnp.asarray(coarse)), axis=1))
    assert np.array_equal(leaf // 8, a1)


def test_tree_transform_normalised_and_empty(corpus):
    desc, _ = corpus
    coarse, leaves = train_vocabulary_tree(desc, branching=(4, 8), iters=4)
    vocab = Vocabulary(leaves, coarse=coarse)
    d = jnp.asarray(desc[:64])
    bow = np.asarray(vocab.transform(d, jnp.ones(64, bool)))
    assert bow.shape == (32,)
    assert abs(np.linalg.norm(bow) - 1.0) < 1e-5
    empty = np.asarray(vocab.transform(d, jnp.zeros(64, bool)))
    assert np.all(empty == 0)  # empty-BoW gate semantics (loop_closure.cpp:122)


def test_tree_separates_places_better_than_chance(corpus):
    desc, places = corpus
    vocab = Vocabulary.fit(
        [desc[i * 100 : (i + 1) * 100] for i in range(8)],
        branching=(4, 8), iters=6,
    )
    bows = np.stack([
        np.asarray(vocab.transform(jnp.asarray(desc[i * 100 : (i + 1) * 100])))
        for i in range(8)
    ])
    S = bows @ bows.T
    same = np.diag(S).mean()
    cross = S[~np.eye(8, dtype=bool)].mean()
    assert same > cross + 0.3, (same, cross)


def test_tree_save_load_roundtrip(tmp_path, corpus):
    desc, _ = corpus
    vocab = Vocabulary.fit(desc, branching=(4, 8), iters=4)
    p = tmp_path / "tree.npz"
    vocab.save(p)
    back = Vocabulary.load(p)
    assert back.coarse is not None
    assert np.array_equal(np.asarray(back.coarse), np.asarray(vocab.coarse))
    assert np.array_equal(np.asarray(back.centroids), np.asarray(vocab.centroids))
    d = jnp.asarray(desc[:32])
    assert np.allclose(
        np.asarray(back.transform(d)), np.asarray(vocab.transform(d))
    )


def test_flat_load_still_works(tmp_path, corpus):
    desc, _ = corpus
    vocab = Vocabulary.fit(desc, num_words=16, iters=4)
    p = tmp_path / "flat.npz"
    vocab.save(p)
    back = Vocabulary.load(p)
    assert back.coarse is None
    assert back.num_words == 16


def test_shipped_tree_vocabulary_loads():
    from pathlib import Path

    v = Vocabulary.load(Path(__file__).parent.parent / "configs" / "vocabulary_tree.npz")
    assert v.coarse is not None
    assert v.num_words == 4096


def test_eval_vocabulary_harness_runs():
    """The retrieval-quality harness evaluates the shipped vocabularies
    and reports the loop-ranking / false-candidate metrics."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent.parent / "tools"))
    from pathlib import Path

    from eval_vocabulary import evaluate
    from tpuslam.config.schema import LoopClosureConfig

    repo = Path(__file__).parent.parent
    lc_cfg = LoopClosureConfig.from_yaml(repo / "configs" / "loop_closure.yml")
    out = evaluate(repo / "configs" / "vocabulary_tree.npz", lc_cfg)
    assert out["words"] == 4096 and out["tree"]
    assert len(out["loops"]) == 2
    # the shipped tree ranks the reference's own loop fixture correctly
    # (test_loop_closure.cpp:81-83 oracle: last frame of loop2 -> frame 0)
    assert out["loops"][1]["rank0_correct"]
    assert 0.0 <= out["forward_false_candidate_rate"] <= 1.0
