"""tpuslam — a monocular visual-SLAM framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the reference
C++ SLAM system (daviyan5/SLAM-CIN0051): image undistortion, FAST corner
detection, intensity-centroid orientation, steered BRIEF descriptors,
brute-force Hamming matching with spatial-jump penalty and Lowe ratio test,
two-view essential-matrix pose estimation with batched RANSAC, DLT
triangulation, bag-of-words loop closure with RANSAC DLT-PnP geometric
verification, fixed-shape map state, sliding-window bundle adjustment, and
multi-sequence sharding over a device mesh.

Design stance (accelerator-first, not a translation):
  * immutable pytree state, fixed shapes + validity masks everywhere
  * ``lax.scan`` over time, ``vmap`` over keypoints/hypotheses/frames
  * batched RANSAC (all hypotheses scored at once) instead of loops
  * Hamming matching as an int8 bit-matmul, FAST as a vectorized stencil
  * ``shard_map`` over a device mesh for multi-sequence throughput
"""

__version__ = "0.1.0"

from tpuslam.common.camera import Camera  # noqa: F401
