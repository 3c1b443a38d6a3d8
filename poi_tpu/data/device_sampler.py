"""Device-resident batch sampling (the loader's zero-transfer fast path).

The host loaders (``pipeline.py``) assemble every batch on CPU and ship
~0.6 MB/step over PCIe. When the training examples fit in device memory —
check-in datasets are tiny by accelerator standards (the 1M-POI config's
*example* arrays are still ≲ a few GB; tables dominate, not sequences) —
the example arrays are uploaded ONCE, and each batch is sampled inside the
jitted train step with a PRNG index gather. The
per-step host→device payload drops to zero and the data pipeline stops being
a pipeline at all.

Sampling semantics: uniform WITH replacement, keyed by ``fold_in(seed, step)``
— stateless, so checkpoint/resume needs no loader state and step N always
draws batch N. This differs from the host loaders' epoch-permutation order
(documented; the epoch loaders remain the default and the quality-parity
path). Select with ``data.sampler = "device"``.

Single-process only for now: examples are replicated across local devices and
the gathered batch is sharded over 'data' by the index sharding. Multi-host
device sampling would need per-host example stripes — use the host loaders
there (they already stripe).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from poi_tpu.data.dataset import Examples
from poi_tpu.data.pipeline import Batch

_FIELDS = (
    "user", "poi_in", "poi_tgt", "mask", "time_bucket",
    "geo_bucket", "tgap_idx", "tgap_frac", "dist_idx", "dist_frac",
)


class DeviceSampler:
    def __init__(self, examples: Examples, batch_size: int, seed: int):
        if jax.process_count() > 1:
            raise ValueError(
                "data.sampler='device' is single-process; multi-host runs use the "
                "host loaders' per-host stripes (data.loader_backend)"
            )
        self.batch_size = batch_size
        self.num_examples = len(examples)
        self._key = jax.random.key(seed)
        # One-time upload; replicated (small next to the embedding tables).
        self._dev = {f: jnp.asarray(getattr(examples, f)) for f in _FIELDS}

    def sample(self, step: jax.Array) -> Batch:
        """Jittable: draw the deterministic batch for ``step``."""
        idx = jax.random.randint(
            jax.random.fold_in(self._key, step), (self.batch_size,), 0, self.num_examples
        )
        b = {f: jnp.take(v, idx, axis=0) for f, v in self._dev.items()}
        b["mask"] = b["mask"].astype(jnp.float32)
        return Batch(**b)
