"""Row log-sum-exp over a streamed score table: Pallas kernels for the GPU,
compiled through Triton.

``online_lse(q, table, bias, row_ids, col_ids)`` returns, for every query
row n,

    lse[n] = log sum_v exp(q[n] . table[v] + bias[v])

over the columns v with ``col_ids[v] != row_ids[n]`` (the accidental hits of
a sampled-softmax pool; pass ``None`` for both to keep every column). It is
the one kernel behind both large-catalog objectives:

- full-catalog CE: ``nll = lse(q, E, b) - (q . E[y] + b[y])``;
- sampled softmax: ``nll = logaddexp(lse(q, E[pool], b[pool] - logQ), s_pos)
  - s_pos``, with the pool ids excluded where they equal the row's target.

The [N, V] logit matrix never reaches device memory. The structure follows
the flash-attention kernels shipped with JAX
(``jax/experimental/pallas/ops/gpu/attention.py``), adapted to a reduction
with no value matrix:

- forward: one program per row block loops over vocab tiles, keeping the
  running max and sum in registers;
- backward: one kernel per row block computes dq, looping over vocab tiles;
  one kernel per vocab block computes dtable and dbias, looping over row
  tiles (split over a second grid axis when the vocab alone gives too few
  programs to fill the card; the partial sums are added outside).

Nothing is carried between programs and no atomics are used, so results do
not depend on scheduling order.

Numerics: bf16 operands with fp32 accumulation for every matrix product;
exponentials and sums in fp32. Excluded and padded columns carry a -1e30
logit, exactly as the plain references in ``train/losses.py`` mask them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG = -1e30
# Programs wanted per launch before the dtable kernel splits its row loop:
# two waves over the card's 132 streaming multiprocessors.
_MIN_PROGRAMS = 264


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_width(d: int) -> int:
    """Feature width the kernels run at: a power of two, at least 16 (the
    smallest tensor-core operand Triton accepts)."""
    return max(16, 1 << (int(d) - 1).bit_length())


def blocks(d: int) -> dict:
    """Tile sizes by padded feature width. Register use per program is what
    bounds them: the dq and dtable accumulators are [tile, d] fp32."""
    if d <= 128:
        return dict(fwd_rows=128, fwd_cols=128, dq_rows=64, dq_cols=128,
                    dt_cols=64, dt_rows=128, warps=4 if d <= 64 else 8, stages=2)
    if d <= 256:
        return dict(fwd_rows=64, fwd_cols=128, dq_rows=64, dq_cols=64,
                    dt_cols=64, dt_rows=64, warps=8, stages=2)
    return dict(fwd_rows=64, fwd_cols=64, dq_rows=32, dq_cols=64,
                dt_cols=32, dt_rows=64, warps=8, stages=2)


def _params(bl: dict):
    return plgpu.CompilerParams(num_warps=bl["warps"], num_stages=bl["stages"])


def _logits(q, t, b, rid, cid):
    """[rows, cols] fp32 logits of one tile; excluded columns at NEG."""
    s = pl.dot(q, t, trans_b=True) + b[None, :]
    if rid is not None:
        s = jnp.where(rid[:, None] == cid[None, :], NEG, s)
    return s


def _split_refs(refs, exclude: bool):
    if exclude:
        return refs[0], refs[1], refs[2:]
    return None, None, refs


def _lse_kernel(q_ref, t_ref, b_ref, *refs, cols: int, exclude: bool):
    rid_ref, cid_ref, (lse_ref,) = _split_refs(refs, exclude)
    q = q_ref[...]
    rid = rid_ref[...] if exclude else None

    def body(j, carry):
        m, l = carry
        sl = pl.ds(pl.multiple_of(j * cols, cols), cols)
        s = _logits(q, t_ref[sl, :], b_ref[sl], rid, cid_ref[sl] if exclude else None)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        l = l * jnp.exp(m - m_new) + jnp.sum(jnp.exp(s - m_new[:, None]), axis=1)
        return m_new, l

    m0 = jnp.full((q.shape[0],), NEG, jnp.float32)
    m, l = lax.fori_loop(0, t_ref.shape[0] // cols, body, (m0, jnp.zeros_like(m0)))
    lse_ref[...] = m + jnp.log(l)


def _dq_kernel(q_ref, t_ref, b_ref, lse_ref, g_ref, *refs, cols: int, exclude: bool):
    rid_ref, cid_ref, (dq_ref,) = _split_refs(refs, exclude)
    q = q_ref[...]
    lse, g = lse_ref[...], g_ref[...]
    rid = rid_ref[...] if exclude else None

    def body(j, acc):
        sl = pl.ds(pl.multiple_of(j * cols, cols), cols)
        t = t_ref[sl, :]
        s = _logits(q, t, b_ref[sl], rid, cid_ref[sl] if exclude else None)
        p = jnp.exp(s - lse[:, None]) * g[:, None]
        return acc + pl.dot(p.astype(t.dtype), t)

    acc = jnp.zeros(dq_ref.shape, jnp.float32)
    dq_ref[...] = lax.fori_loop(0, t_ref.shape[0] // cols, body, acc)


def _dt_kernel(q_ref, t_ref, b_ref, lse_ref, g_ref, *refs, rows: int, exclude: bool):
    rid_ref, cid_ref, (dt_ref, db_ref) = _split_refs(refs, exclude)
    t, b = t_ref[...], b_ref[...]
    cid = cid_ref[...] if exclude else None

    def body(i, carry):
        acc, acc_b = carry
        sl = pl.ds(pl.multiple_of(i * rows, rows), rows)
        q = q_ref[sl, :]
        s = _logits(q, t, b, rid_ref[sl] if exclude else None, cid)
        p = jnp.exp(s - lse_ref[sl][:, None]) * g_ref[sl][:, None]
        acc = acc + pl.dot(p.astype(q.dtype), q, trans_a=True)
        return acc, acc_b + jnp.sum(p, axis=0)

    carry = (jnp.zeros(dt_ref.shape[-2:], jnp.float32), jnp.zeros(db_ref.shape[-1:], jnp.float32))
    acc, acc_b = lax.fori_loop(0, q_ref.shape[0] // rows, body, carry)
    dt_ref[...] = acc.reshape(dt_ref.shape)
    db_ref[...] = acc_b.reshape(db_ref.shape)


def _pad_operands(q, table, bias, row_ids, col_ids):
    """Casts to bf16 and pads rows, columns and width to the tile grid.
    Padded columns get a NEG bias; padded rows are zero queries."""
    n, d = q.shape
    v = table.shape[0]
    dp = padded_width(d)
    bl = blocks(dp)
    rmult = max(bl["fwd_rows"], bl["dq_rows"], bl["dt_rows"])
    cmult = max(bl["fwd_cols"], bl["dq_cols"], bl["dt_cols"])
    n_p, v_p = _round_up(n, rmult), _round_up(v, cmult)
    qp = jnp.pad(q.astype(jnp.bfloat16), ((0, n_p - n), (0, dp - d)))
    tp = jnp.pad(table.astype(jnp.bfloat16), ((0, v_p - v), (0, dp - d)))
    bp = jnp.pad(bias.astype(jnp.float32), (0, v_p - v), constant_values=NEG)
    ids = ()
    if row_ids is not None:
        ids = (
            jnp.pad(row_ids.astype(jnp.int32), (0, n_p - n), constant_values=-2),
            jnp.pad(col_ids.astype(jnp.int32), (0, v_p - v), constant_values=-1),
        )
    return qp, tp, bp, ids, bl


def _forward(qp, tp, bp, ids, bl, interpret):
    n_p, dp = qp.shape
    v_p = tp.shape[0]
    rows = bl["fwd_rows"]
    exclude = bool(ids)
    in_specs = [
        pl.BlockSpec((rows, dp), lambda i: (i, 0)),
        pl.BlockSpec((v_p, dp), lambda i: (0, 0)),
        pl.BlockSpec((v_p,), lambda i: (0,)),
    ]
    if exclude:
        in_specs += [pl.BlockSpec((rows,), lambda i: (i,)), pl.BlockSpec((v_p,), lambda i: (0,))]
    return pl.pallas_call(
        functools.partial(_lse_kernel, cols=bl["fwd_cols"], exclude=exclude),
        grid=(n_p // rows,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((rows,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n_p,), jnp.float32),
        compiler_params=_params(bl),
        interpret=interpret,
        name="online_lse_fwd",
    )(qp, tp, bp, *ids)


def _backward(qp, tp, bp, ids, bl, lse_p, g_p, interpret):
    n_p, dp = qp.shape
    v_p = tp.shape[0]
    exclude = bool(ids)
    params = _params(bl)

    rows = bl["dq_rows"]
    in_specs = [
        pl.BlockSpec((rows, dp), lambda i: (i, 0)),
        pl.BlockSpec((v_p, dp), lambda i: (0, 0)),
        pl.BlockSpec((v_p,), lambda i: (0,)),
        pl.BlockSpec((rows,), lambda i: (i,)),
        pl.BlockSpec((rows,), lambda i: (i,)),
    ]
    if exclude:
        in_specs += [pl.BlockSpec((rows,), lambda i: (i,)), pl.BlockSpec((v_p,), lambda i: (0,))]
    dq = pl.pallas_call(
        functools.partial(_dq_kernel, cols=bl["dq_cols"], exclude=exclude),
        grid=(n_p // rows,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((rows, dp), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_p, dp), jnp.float32),
        compiler_params=params,
        interpret=interpret,
        name="online_lse_dq",
    )(qp, tp, bp, lse_p, g_p, *ids)

    cols, rows = bl["dt_cols"], bl["dt_rows"]
    n_cols = v_p // cols
    split = max(1, min(n_p // rows, -(-_MIN_PROGRAMS // n_cols)))
    while (n_p // rows) % split:
        split -= 1
    span = n_p // split  # rows handled by one program
    in_specs = [
        pl.BlockSpec((span, dp), lambda j, s: (s, 0)),
        pl.BlockSpec((cols, dp), lambda j, s: (j, 0)),
        pl.BlockSpec((cols,), lambda j, s: (j,)),
        pl.BlockSpec((span,), lambda j, s: (s,)),
        pl.BlockSpec((span,), lambda j, s: (s,)),
    ]
    if exclude:
        in_specs += [pl.BlockSpec((span,), lambda j, s: (s,)), pl.BlockSpec((cols,), lambda j, s: (j,))]
    dt, db = pl.pallas_call(
        functools.partial(_dt_kernel, rows=rows, exclude=exclude),
        grid=(n_cols, split),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((1, cols, dp), lambda j, s: (s, j, 0)),
            pl.BlockSpec((1, cols), lambda j, s: (s, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((split, v_p, dp), jnp.float32),
            jax.ShapeDtypeStruct((split, v_p), jnp.float32),
        ],
        compiler_params=params,
        interpret=interpret,
        name="online_lse_dtable",
    )(qp, tp, bp, lse_p, g_p, *ids)
    return dq, dt.sum(axis=0), db.sum(axis=0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def online_lse(q, table, bias, row_ids=None, col_ids=None, interpret=False):
    """[N] fp32 row log-sum-exp of ``q @ table.T + bias`` with excluded
    columns skipped. q: [N, D]; table: [V, D]; bias: [V]; row_ids: [N] and
    col_ids: [V] int, or both None. Differentiable in q, table and bias."""
    lse, _ = _lse_fwd(q, table, bias, row_ids, col_ids, interpret)
    return lse


def _lse_fwd(q, table, bias, row_ids, col_ids, interpret):
    if (row_ids is None) != (col_ids is None):
        raise ValueError("row_ids and col_ids go together")
    qp, tp, bp, ids, bl = _pad_operands(q, table, bias, row_ids, col_ids)
    lse_p = _forward(qp, tp, bp, ids, bl, interpret)
    # q, table and bias ride along only for their shapes and dtypes.
    return lse_p[: q.shape[0]], (q, table, bias, qp, tp, bp, ids, lse_p)


def _lse_bwd(interpret, res, g):
    q, table, bias, qp, tp, bp, ids, lse_p = res
    (n, d), v = q.shape, table.shape[0]
    bl = blocks(qp.shape[1])
    n_p = qp.shape[0]
    g_p = jnp.pad(g.astype(jnp.float32), (0, n_p - n))
    # Padded rows: zero cotangent, and an lse that sends exp(s - lse) to 0.
    lse_p = jnp.where(jnp.arange(n_p) < n, lse_p, -NEG)
    dq, dt, db = _backward(qp, tp, bp, ids, bl, lse_p, g_p, interpret)
    return (
        dq[:n, :d].astype(q.dtype),
        dt[:v, :d].astype(table.dtype),
        db[:v].astype(bias.dtype),
        None,
        None,
    )


online_lse.defvjp(_lse_fwd, _lse_bwd)
