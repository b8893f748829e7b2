"""Device-mesh utilities: multi-sequence SLAM sharding.

The reference has no distributed execution of any kind (SURVEY §2: no
MPI/NCCL/threads in implemented code).  The scaling model
(BASELINE config 5) is *sequence parallelism over a mesh*: S independent
video sequences are vmapped into one program and sharded across a
``jax.sharding.Mesh`` axis; per-sequence SLAM state is fully local so XLA
inserts no collectives on the hot path — cross-device traffic happens only
when results are gathered to the host.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join a multi-host JAX cluster (``jax.distributed.initialize``).

    The SURVEY §5 distributed-communication row: on a multi-host GPU
    cluster every host must call this before any mesh is built so
    ``jax.devices()`` spans every host's GPUs and XLA's collectives (NCCL)
    reach them all.  Pass the coordinator address (``host:port``), the
    number of processes and this process's id; without them JAX tries to
    detect a cluster environment.  Returns True when a multi-process runtime is active
    (idempotent; single-host callers get False and a local mesh).
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        # Already initialized, or no cluster environment to detect —
        # single-process operation is the correct fallback for both.
        pass
    return jax.process_count() > 1


def make_device_mesh(n_devices: int | None = None, axis_name: str = "seq") -> Mesh:
    """Mesh over all (global, in multi-host runs) devices.

    After :func:`initialize_multihost`, ``jax.devices()`` returns every
    device in the cluster in a stable order, so the same call shapes a
    one-host mesh (e.g. four NVLink-joined GPUs) and a multi-host mesh.
    The mesh is flat: every GPU of a host reaches every other at the same
    rate, so no torus shape is needed.
    """
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devices)} available."
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def sequence_sharding(mesh: Mesh, axis_name: str = "seq") -> NamedSharding:
    """Shard the leading (sequence) axis across the mesh; replicate the rest."""
    return NamedSharding(mesh, P(axis_name))


def shard_vmapped_step(chunk_fn, mesh: Mesh, state_template: Any,
                       axis_name: str = "seq"):
    """Shard a per-sequence chunk function over the mesh's sequence axis.

    ``chunk_fn(frames (B, H, W), valid (B,), state, key)`` becomes
    ``step(frames (S, B, H, W), valid (S, B), states (S-stacked), keys
    (S, 2)) → (results, new states)`` with every argument and result
    sharded on its leading sequence axis.  Per-sequence state (including a
    persistent map in PnP mode) stays fully local to its device, so XLA
    inserts no collectives on the hot path.
    """
    seq_sharding = sequence_sharding(mesh, axis_name)

    def spec_like(tree: Any):
        return jax.tree.map(lambda _: seq_sharding, tree)

    vmapped = jax.vmap(chunk_fn)

    def step(frames, valid, states, keys):
        frames = jax.lax.with_sharding_constraint(frames, seq_sharding)
        return vmapped(frames, valid, states, keys)

    return jax.jit(
        step,
        in_shardings=(seq_sharding, seq_sharding, spec_like(state_template),
                      seq_sharding),
    )


def shard_batched_pipeline(pipeline, mesh: Mesh, axis_name: str = "seq"):
    """Jitted multi-sequence VO chunk step sharded over ``mesh``."""
    return shard_vmapped_step(
        pipeline._process_chunk, mesh, pipeline.initial_state(), axis_name
    )


def shard_sequence_program(sequence_impl, mesh: Mesh, axis_name: str = "seq"):
    """One FULL SLAM sequence program per device via ``shard_map``.

    ``sequence_impl(chunks (C,B,H,W), valid (C,B), carry, keys (C,2))`` —
    e.g. ``SlamSystem._sequence_impl`` — becomes ``step(chunks (S,C,B,H,W),
    valid (S,C,B), carries (S-stacked), keys (S,C,2)) → (carries, outs)``
    with S = mesh size, every argument/result sharded on its leading
    sequence axis.

    Why not ``vmap`` + sharding constraints (the previous formulation):
    ``vmap`` lowers every ``lax.cond`` inside the chunk program to a
    both-branches select, so the rare-path stages — loop-closure geometric
    verification on no-candidate chunks, PnP tracking's RANSAC fallback
    when motion-model descent fails, relocalization on healthy chunks —
    get paid unconditionally on every chunk of every sequence.  Under
    ``shard_map`` each sequence stays a *rank-preserved scalar program* on
    its own device, and each device executes data-dependent control flow
    independently, so the conds remain real branches; the mesh axis is pure SPMD with no collectives (per-sequence SLAM state is
    fully local, exactly as the vmap layout had it).
    """
    spec = P(axis_name)

    def body(chunks, valid, carry, keys):
        # Per-shard leading axis is S / mesh-size = 1: peel it, run the
        # unbatched sequence program (real conds), restore it.
        carry1 = jax.tree.map(lambda a: a[0], carry)
        carry2, outs = sequence_impl(chunks[0], valid[0], carry1, keys[0])
        lead = lambda a: a[None]  # noqa: E731
        return jax.tree.map(lead, carry2), jax.tree.map(lead, outs)

    # check_vma=False: the body is embarrassingly parallel (no collectives),
    # and the varying-axes checker false-positives on loop carries whose
    # init is mesh-invariant (e.g. the identity-matrix V0 of the Jacobi
    # eigensolver) while the data operand varies.
    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(spec, spec),
            check_vma=False,
        )
    )
