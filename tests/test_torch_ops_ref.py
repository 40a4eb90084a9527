"""Port parity: the plain reference ops (superllama_tpu_torch.ops.ref) and the
KV-cache bookkeeping (runtime.kv_cache) against the JAX package's
``ops/jnp_ref.py`` and ``runtime/kv_cache.py`` on numpy-seeded inputs.

Elementwise transcendentals (rsqrt, exp, tanh, pow) may differ by an ulp
between XLA and torch, so float results are held to rtol = atol = 1e-6 in
f32; masks and cache positions must match exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.ops import jnp_ref as J
from superllama_tpu.runtime import kv_cache as JK
from superllama_tpu_torch.ops import ref as T
from superllama_tpu_torch.runtime import kv_cache as TK

TOL = dict(rtol=1e-6, atol=1e-6)
rng = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm(with_weight):
    x = rng.normal(0, 2, (3, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, 64).astype(np.float32) if with_weight else None
    _close(T.rms_norm(_t(x), None if w is None else _t(w), 1e-5),
           J.rms_norm(jnp.asarray(x), None if w is None else jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("kw", [{}, {"freq_scale": 0.25},
                                {"freq_scale": 0.25, "ext_factor": 1.0, "orig_ctx": 4096}],
                         ids=["plain", "linear", "yarn"])
def test_rope_frequencies(kw):
    got, gm = T.rope_frequencies(128, 128, 500000.0, **kw)
    ref, rm = J.rope_frequencies(128, 128, 500000.0, **kw)
    _close(got, ref, rtol=1e-6, atol=0)
    assert gm == pytest.approx(rm)


@pytest.mark.parametrize("rope_type", [T.ROPE_TYPE_NORM, T.ROPE_TYPE_NEOX],
                         ids=["norm", "neox"])
def test_apply_rope(rope_type):
    x = rng.normal(0, 1, (2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    fj, _ = J.rope_frequencies(64, 48, 10000.0)     # partial rotation
    ft, _ = T.rope_frequencies(64, 48, 10000.0)
    _close(T.apply_rope(_t(x), _t(pos), ft, rope_type, 1.1),
           J.apply_rope(jnp.asarray(x), jnp.asarray(pos), fj, rope_type, 1.1),
           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["attention_ref", "attention_gqa"])
@pytest.mark.parametrize("sinks,softcap", [(False, 0.0), (True, 0.0), (False, 20.0)],
                         ids=["plain", "sinks", "softcap"])
def test_attention(fn, sinks, softcap):
    B, T_, H, Hkv, S, D = 2, 5, 8, 2, 24, 32
    q = rng.normal(0, 1, (B, T_, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    cpos = np.where(np.arange(S) < 15, np.arange(S), -1).astype(np.int32)[None].repeat(B, 0)
    qpos = (np.arange(T_) + 10).astype(np.int32)[None].repeat(B, 0)
    qpos[1, -1] = -1                                   # a padded row
    sk = rng.normal(0, 1, H).astype(np.float32) if sinks else None
    mj = JK.causal_mask(jnp.asarray(cpos), jnp.asarray(qpos), 4)
    mt = TK.causal_mask(_t(cpos), _t(qpos), 4)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    ref = getattr(J, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mj,
                         logit_softcap=softcap,
                         sinks=None if sk is None else jnp.asarray(sk))
    got = getattr(T, fn)(_t(q), _t(k), _t(v), mt, logit_softcap=softcap,
                         sinks=None if sk is None else _t(sk))
    _close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", sorted(T.GLU_FNS))
def test_glu(act):
    g = rng.normal(0, 2, (4, 33)).astype(np.float32)
    u = rng.normal(0, 2, (4, 33)).astype(np.float32)
    _close(T.GLU_FNS[act](_t(g), _t(u)), J.GLU_FNS[act](jnp.asarray(g), jnp.asarray(u)),
           rtol=1e-5, atol=1e-5)


def test_softmax_ext():
    x = rng.normal(0, 3, (2, 3, 17)).astype(np.float32)
    m = np.where(rng.random((2, 3, 17)) < 0.3, -np.inf, 0.0).astype(np.float32)
    m[..., 0] = 0.0
    _close(T.softmax_ext(_t(x), _t(m), 0.7), J.softmax_ext(jnp.asarray(x), jnp.asarray(m), 0.7))


def test_kv_cache_ops_match_jax():
    """Writes past the cache end are dropped (JAX) / routed to the spare slot
    (port); positions, cursors and visible K/V agree exactly."""
    L, B, S, Hkv, D = 2, 3, 10, 2, 4
    jc = JK.kv_cache_init(L, B, S, Hkv, D, dtype=jnp.float32)
    tc = TK.kv_cache_init(L, B, S, Hkv, D, dtype=torch.float32)
    for T_, pos in ((4, [[0, 1, 2, 3], [0, 1, -1, -1], [-1, -1, -1, -1]]),
                    (4, [[4, 5, 6, 7], [2, 3, 4, 5], [0, 1, 2, 3]]),
                    (4, [[8, 9, 10, 11], [6, -1, -1, -1], [4, 5, -1, -1]])):
        pos = np.asarray(pos, np.int32)
        kn = rng.normal(0, 1, (B, T_, Hkv, D)).astype(np.float32)
        vn = rng.normal(0, 1, (B, T_, Hkv, D)).astype(np.float32)
        js, ts = JK.kv_write_slots(jc, T_), TK.kv_write_slots(tc, T_)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jc = JK.kv_advance(jc, js, jnp.asarray(pos))
        TK.kv_advance(tc, ts, _t(pos))
        for il in range(L):
            jc = JK.kv_update_layer(jc, il, js, jnp.asarray(kn), jnp.asarray(vn))
            TK.kv_update_layer(tc, il, ts, _t(kn), _t(vn))
    np.testing.assert_array_equal(tc.positions().numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.cursor.numpy(), np.asarray(jc.cursor))
    for il in range(L):
        k, v, _, _ = tc.layer(il)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jc.k[il]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jc.v[il]))
    keep = np.array([5, 0, 3], np.int32)
    jc = JK.kv_truncate_rows(jc, jnp.asarray(keep))
    TK.kv_truncate_rows(tc, _t(keep))
    np.testing.assert_array_equal(tc.positions().numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.cursor.numpy(), np.asarray(jc.cursor))


def test_kv_insert_row():
    big = TK.kv_cache_init(1, 3, 6, 1, 2, dtype=torch.float32)
    small = TK.kv_cache_init(1, 1, 6, 1, 2, dtype=torch.float32)
    s = TK.kv_write_slots(small, 4)
    TK.kv_advance(small, s, torch.tensor([[0, 1, 2, -1]], dtype=torch.int32))
    TK.kv_update_layer(small, 0, s, torch.ones((1, 4, 1, 2)), torch.ones((1, 4, 1, 2)))
    TK.kv_insert_row(big, small, 2, 3)
    assert big.positions()[2].tolist() == [0, 1, 2, -1, -1, -1]
    assert big.cursor.tolist() == [0, 0, 3]
    assert float(big.k[0, 2, 0, :3].sum()) == 6.0 and float(big.k[0, :2].abs().sum()) == 0.0
