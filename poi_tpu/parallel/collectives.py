"""The communication backend (SURVEY.md §2.2 T8).

XLA collectives are the ENTIRE comms layer (on the GPU XLA hands them to
NCCL; on the CPU test mesh they run in-process or over gloo). Every
cross-device exchange goes through one of the primitives below, issued
inside ``jax.shard_map`` so program order is identical on every device
(SPMD-by-construction deadlock freedom, SURVEY.md §5 "Race detection").

Usage map:
- ``psum``           gradients over 'data'; softmax partition functions and
                     masked target-logit reduction over 'model'
- ``all_to_all``     embedding id/vector exchange (T3); Ulysses seq<->head
                     reshard (T5)
- ``all_gather``     top-k candidate merge (T9); replicating a2a lookups
- ``ppermute``       ring attention KV rotation (T4)
- ``pmax``           global max for stable sharded log-sum-exp (T10)

These wrappers exist so call-sites name the axis once and the comm pattern is
greppable; they add no behavior over ``jax.lax``.
"""

from __future__ import annotations

import jax

from poi_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS  # noqa: F401  (re-export)


def psum(x, axis: str):
    return jax.lax.psum(x, axis)


def pmax(x, axis: str):
    return jax.lax.pmax(x, axis)


def pmean(x, axis: str):
    return jax.lax.pmean(x, axis)


def all_gather(x, axis: str, *, gather_axis: int = 0, tiled: bool = True):
    """Concatenate per-device blocks along ``gather_axis``."""
    return jax.lax.all_gather(x, axis, axis=gather_axis, tiled=tiled)


def all_to_all(x, axis: str, *, split_axis: int, concat_axis: int, tiled: bool = False):
    """Transpose a device-sharded axis with an in-array axis.

    tiled=False: ``split_axis`` must equal the axis size and is consumed; a
    new device-indexed axis appears at ``concat_axis``.
    tiled=True: ``split_axis`` is cut into axis-size pieces in place and
    received pieces concatenate onto ``concat_axis`` (symmetric under
    transpose — prefer this in differentiated code).
    """
    return jax.lax.all_to_all(x, axis, split_axis=split_axis, concat_axis=concat_axis, tiled=tiled)


def ppermute_ring(x, axis: str, *, shift: int = 1):
    """Rotate blocks around the ring defined by mesh ``axis`` (ring attention)."""
    n = jax.lax.axis_size(axis)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis, perm)


def axis_index(axis: str):
    return jax.lax.axis_index(axis)


def axis_size(axis: str):
    return jax.lax.axis_size(axis)
