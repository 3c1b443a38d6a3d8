"""Ring vs Ulysses vs replicated-blockwise attention: collective traffic.

VERDICT r4 Missing #4: the SP attention modes (T4/T5) had correctness
evidence but no measured basis, and config #5 silently ran the default
blockwise. Same methodology as compare_embedding_modes.py: this compiles the
attention
block (including the P('data',None,None) ↔ P('data','model',None) reshard
boundaries the SP modes impose on the surrounding tower) fwd+bwd on a fake
8-device mesh at config-#5 dims and counts per-device collective bytes in
the optimized HLO; config #5's attn_impl choice cites them.

    python scripts/compare_attention_modes.py [--dim 512] [--window 16]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from compare_embedding_modes import collective_bytes  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--seqlen", type=int, default=64)
    args = p.parse_args(argv)

    from poi_tpu.models.attention import init_mha
    from poi_tpu.ops.attention import multihead_attention
    from poi_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
    from poi_tpu.parallel.sp_attention import make_sp_attention

    B, T, D, H, W = args.batch, args.seqlen, args.dim, args.heads, args.window
    params = init_mha(jax.random.key(0), D)
    print(
        f"attention block fwd+bwd, B={B} T={T} D={D} heads={H} window={W} "
        f"(activation {B * T * D * 4 / 1e6:.1f} MB fp32); wire MB/device = "
        f"ring-protocol-weighted payload, reshard boundaries included"
    )
    print(f"{'model':>5} {'impl':>10} {'wire MB/dev':>12}  breakdown")
    for m in (2, 4, 8):
        mesh = make_mesh(data=8 // m, model=m)
        wire = {
            "all-reduce": 2.0 * (m - 1) / m,
            "all-gather": (m - 1) / m,
            "all-to-all": (m - 1) / m,
            "reduce-scatter": (m - 1) / m,
            "collective-permute": 1.0,
        }
        for impl in ("blockwise", "ring", "ulysses"):
            if impl == "blockwise":
                mha = lambda h, p: multihead_attention(h, p, num_heads=H, window=W)
            else:
                mha = make_sp_attention(mesh, H, W, impl)

            def block(h, pp):
                o = mha(h, pp)
                # The surrounding tower consumes h + o with the time axis
                # unsharded (residual + layer norm + the downstream loss), so
                # the SP modes pay their reshard here; the replicated mode is
                # already in this layout.
                o = jax.lax.with_sharding_constraint(
                    o, jax.NamedSharding(mesh, jax.P(DATA_AXIS, None, None))
                )
                return jnp.sum((h.astype(jnp.float32) + o) ** 2)

            h_spec = jax.ShapeDtypeStruct(
                (B, T, D), jnp.float32,
                sharding=jax.NamedSharding(mesh, jax.P(DATA_AXIS, None, None)),
            )
            p_spec = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(
                    x.shape, x.dtype, sharding=jax.NamedSharding(mesh, jax.P())
                ),
                params,
            )
            hlo = (
                jax.jit(jax.grad(block, argnums=(0, 1)))
                .lower(h_spec, p_spec)
                .compile()
                .as_text()
            )
            counts = collective_bytes(hlo)
            wired = sum(b * wire.get(k, 1.0) for k, b in counts.items())
            pretty = ", ".join(f"{k}={b / 1e6:.2f}MB" for k, b in sorted(counts.items()))
            print(f"{m:>5} {impl:>10} {wired / 1e6:>12.2f}  {pretty or '(none)'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
