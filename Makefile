# Developer driver (the reference ships a Makefile with release/test/format
# targets, Makefile:7-37; these are the JAX-framework equivalents).

PY ?= python

.PHONY: test test-fast bench native vocab dryrun lint clean

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -k "not system and not pipeline"

bench:
	$(PY) bench.py

native:
	$(MAKE) -C native

# Reproduces the shipped vocabulary: 256 words trained on the fixture
# corpus itself.  Measured trade-off (round 2): training on an augmented /
# wider corpus (--augment 6, 512-1024 words) generalises the words but
# *lowers* BoW retrieval precision on the self-similar indoor fixture
# (frame-9-vs-frame-0 no longer ranks first) — vocabulary should be trained
# on domain-representative imagery; use --augment for new domains.
vocab:
	JAX_PLATFORMS=cpu $(PY) tools/train_vocabulary.py -o configs/vocabulary.npz \
		tests/data/images tests/data/images_test_loop2 tests/data/test_images

dryrun:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) __graft_entry__.py 8

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true

lint:
	@command -v ruff >/dev/null 2>&1 && ruff check tpuslam tools tests bench.py chip_smoke.py __graft_entry__.py || $(PY) tools/lint.py
