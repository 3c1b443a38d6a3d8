"""The recurrent cells (lax.scan) vs NumPy oracles written from the
equations, at several (B, H, T) with validity-prefix masks: padded steps
carry the state through unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poi_tpu.models.gru import gru_layer, init_gru_layer
from poi_tpu.models.lstm import init_lstm_layer, lstm_layer
from poi_tpu.models.strnn import init_strnn_layer

SHAPES = [(2, 8, 5), (3, 16, 7), (4, 32, 12)]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _inputs(B, T, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return x, mask


def _np(p):
    return {k: np.asarray(v, np.float64) for k, v in p.items()}


def gru_oracle(p, x, mask):
    p = _np(p)
    B, T, _ = x.shape
    H = p["wh"].shape[0]
    h = np.zeros((B, H))
    out = np.zeros((B, T, H))
    for t in range(T):
        xw = x[:, t] @ p["wx"] + p["b"]
        hw = h @ p["wh"]
        z = _sigmoid(xw[:, :H] + hw[:, :H])
        r = _sigmoid(xw[:, H:2 * H] + hw[:, H:2 * H])
        n = np.tanh(xw[:, 2 * H:] + r * hw[:, 2 * H:])
        h_new = (1 - z) * h + z * n
        out[:, t] = h_new
        h = np.where(mask[:, t:t + 1] > 0, h_new, h)
    return out


def lstm_oracle(p, x, mask):
    p = _np(p)
    B, T, _ = x.shape
    H = p["wh"].shape[0]
    h, c = np.zeros((B, H)), np.zeros((B, H))
    out = np.zeros((B, T, H))
    for t in range(T):
        a = x[:, t] @ p["wx"] + p["b"] + h @ p["wh"]
        i, f = _sigmoid(a[:, :H]), _sigmoid(a[:, H:2 * H])
        g, o = np.tanh(a[:, 2 * H:3 * H]), _sigmoid(a[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * np.tanh(c_new)
        out[:, t] = h_new
        keep = mask[:, t:t + 1] > 0
        h, c = np.where(keep, h_new, h), np.where(keep, c_new, c)
    return out


@pytest.mark.parametrize("B,H,T", SHAPES)
@pytest.mark.parametrize("remat", [False, True])
def test_gru_matches_oracle(B, H, T, remat):
    x, mask = _inputs(B, T, H, seed=B * T)
    p = init_gru_layer(jax.random.key(B), H, H)
    got = gru_layer(p, jnp.asarray(x), jnp.asarray(mask), jnp.float32, remat=remat)
    np.testing.assert_allclose(np.asarray(got), gru_oracle(p, x, mask), atol=2e-5)


@pytest.mark.parametrize("B,H,T", SHAPES)
def test_lstm_matches_oracle(B, H, T):
    x, mask = _inputs(B, T, H, seed=B + T)
    p = init_lstm_layer(jax.random.key(T), H, H)
    got = lstm_layer(p, jnp.asarray(x), jnp.asarray(mask), jnp.float32)
    np.testing.assert_allclose(np.asarray(got), lstm_oracle(p, x, mask), atol=2e-5)


@pytest.mark.parametrize("B,H,T", SHAPES)
def test_strnn_matches_oracle(B, H, T):
    """The ST-RNN tower: interpolated spatial then temporal transitions on
    the inputs, then h_t = tanh(W_in^T (T S x_t) + b + C h_{t-1})."""
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.pipeline import Batch
    from poi_tpu.models.base import DataDims, build_model

    K = 4
    cfg = get_config("smoke").with_overrides(
        {"model.kind": "strnn", "model.embed_dim": str(H), "model.hidden_dim": str(H),
         "model.compute_dtype": "float32"}
    )
    dims = DataDims(num_users=2, num_pois=2, num_time_buckets=4, num_geo_buckets=4,
                    num_tgap_buckets=K, num_dist_buckets=K)
    model = build_model(cfg.model, dims)
    x, mask = _inputs(B, T, H, seed=7 * B + T)
    rng = np.random.default_rng(T)
    ti, di = rng.integers(0, K, (B, T)), rng.integers(0, K, (B, T))
    tf, df = rng.random((B, T)).astype(np.float32), rng.random((B, T)).astype(np.float32)
    p = init_strnn_layer(jax.random.key(H), H, H, K, K)
    zi = np.zeros((B, T), np.int32)
    batch = Batch(user=np.zeros(B, np.int32), poi_in=zi, poi_tgt=zi, mask=mask, time_bucket=zi,
                  geo_bucket=zi, tgap_idx=ti.astype(np.int32), tgap_frac=tf,
                  dist_idx=di.astype(np.int32), dist_frac=df)
    got = model.tower({"layer": p}, jnp.asarray(x), batch)

    q = _np(p)

    def lerp(tabs, v, idx, frac):
        lo = np.einsum("btd,bted->bte", v, tabs[idx])
        hi = np.einsum("btd,bted->bte", v, tabs[idx + 1])
        return (1 - frac[..., None]) * lo + frac[..., None] * hi

    xin = lerp(q["t_tab"], lerp(q["s_tab"], x.astype(np.float64), di, df), ti, tf) @ q["w_in"] + q["b"]
    h = np.zeros((B, H))
    want = np.zeros((B, T, H))
    for t in range(T):
        h_new = np.tanh(xin[:, t] + h @ q["c"])
        want[:, t] = h_new
        h = np.where(mask[:, t:t + 1] > 0, h_new, h)
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-5)


def test_padded_steps_do_not_change_the_last_valid_state():
    """Whatever follows a row's last valid step, its state there is the
    same (the eval path reads the state at the last valid position)."""
    B, H, T = 3, 16, 9
    x, mask = _inputs(B, T, H, seed=11)
    p = init_gru_layer(jax.random.key(0), H, H)
    noisy = x.copy()
    noisy[mask == 0] = 100.0
    a = np.asarray(gru_layer(p, jnp.asarray(x), jnp.asarray(mask), jnp.float32))
    b = np.asarray(gru_layer(p, jnp.asarray(noisy), jnp.asarray(mask), jnp.float32))
    last = mask.sum(1).astype(int) - 1
    np.testing.assert_allclose(a[np.arange(B), last], b[np.arange(B), last], atol=1e-6)
