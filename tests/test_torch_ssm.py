"""Port parity of the state-space pieces (superllama_tpu_torch/ops/ssm_scan.py,
models/mamba.py, runtime/recurrent.py, runtime/cache_policy.py) against the
JAX package, on the CPU:

 - the plain selective scan against the JAX mixers' ``jax.lax.scan`` of
   their step functions, in the three forms (mamba1; mamba2 with G 1, 2
   and 4; plamo2's one group), with idle rows;
 - each mixer against the JAX one (``_mamba_mixer`` plain, with jamba's
   norms and with falcon-mamba's ``ssm_dt_b_c_rms``; ``_mamba2_mixer`` with
   and without ``ssm_norm``; ``plamo2_mixer``): outputs and both states;
 - a 12-token step then two 1-token steps equal to one 14-token step (the
   conv and SSM carry), and idle rows keeping their state;
 - ``mask_rows``, ``truncate_rows``, ``get_row`` / ``set_row``,
   ``pow2_chunk``, ``make_cache`` and ``seq_keep_row`` against the JAX
   functions on recurrent and hybrid caches, the caches carried across;
 - ``ssm_scan``'s launch on CUDA-typed tensors through a recording stand-in
   for the library, its thread split, its refusals and a failed build
   raising.

Tolerances: the scan 1e-5 (f32; y sums over the states in another order);
the mixers 1e-5 (rtol and atol, f32); cache operations exact.
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from superllama_tpu.models import jamba as jjamba
from superllama_tpu.models import mamba as jmamba
from superllama_tpu.models.hparams import HParams as JHParams
from superllama_tpu.runtime import cache_policy as jcp
from superllama_tpu.runtime import recurrent as jrec
from superllama_tpu_torch import convert
from superllama_tpu_torch.models import mamba as tmamba
from superllama_tpu_torch.models.hparams import HParams
from superllama_tpu_torch.ops import _build
from superllama_tpu_torch.ops import ssm_scan as ss
from superllama_tpu_torch.runtime import cache_policy as tcp
from superllama_tpu_torch.runtime import recurrent as trec
from test_torch_fixtures import cuda_typed, failing_build

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ the scan


@jax.jit
def _jax_scan(state, x, dt, A, Bm, Cm):
    """``jax.lax.scan`` of the JAX mixers' step functions as written there
    (superllama_tpu/models/mamba.py:64-70 with A (nh, ds) and one channel a
    head, :123-131 and :186-194 with a decay a head); inputs in the port's
    (B, T, nh, hd) / (B, T, G, ds) layout."""
    nh = x.shape[2]
    G = Bm.shape[2]
    if A.ndim == 2:                                    # mamba1: (B, di, ds) state
        def step(st, inp):
            dt_t, b_t, c_t, x_t = inp
            dA = jnp.exp(dt_t[..., None] * A[None])
            dBx = (dt_t * x_t)[..., None] * b_t[:, None, :]
            st = st * dA + dBx
            return st, jnp.einsum("bds,bs->bd", st, c_t)
        st, ys = jax.lax.scan(step, state[:, :, 0], (
            dt.transpose(1, 0, 2), Bm[:, :, 0].transpose(1, 0, 2),
            Cm[:, :, 0].transpose(1, 0, 2), x[..., 0].transpose(1, 0, 2)))
        return st[:, :, None], ys.transpose(1, 0, 2)[..., None]

    def step(st, inp):
        dt_t, b_t, c_t, x_t = inp
        dA = jnp.exp(dt_t * A)
        b_h = jnp.repeat(b_t, nh // G, axis=1)
        c_h = jnp.repeat(c_t, nh // G, axis=1)
        dBx = (dt_t[..., None] * x_t)[..., None] * b_h[:, :, None, :]
        st = st * dA[..., None, None] + dBx
        return st, jnp.einsum("bhds,bhs->bhd", st, c_h)
    st, ys = jax.lax.scan(step, state, (
        dt.transpose(1, 0, 2), Bm.transpose(1, 0, 2, 3), Cm.transpose(1, 0, 2, 3),
        x.transpose(1, 0, 2, 3)))
    return st, ys.transpose(1, 0, 2, 3)


def _scan_inputs(form: str, G: int, T: int, Bt: int = 3, seed: int = 0):
    rng = _rng(seed)
    if form == "mamba1":
        nh, hd, ds = 24, 1, 16
        A = -np.exp(_f(rng, nh, ds, scale=0.5))
    else:
        nh, hd, ds = 8, 4, 32
        A = -np.exp(_f(rng, nh, scale=0.5))
    dt = np.log1p(np.exp(_f(rng, Bt, T, nh)))
    return (_f(rng, Bt, nh, hd, ds), _f(rng, Bt, T, nh, hd), dt.astype(np.float32), A,
            _f(rng, Bt, T, G, ds), _f(rng, Bt, T, G, ds))


SCAN_CASES = [("mamba1", 1), ("mamba2", 1), ("mamba2", 2), ("mamba2", 4), ("plamo2", 1)]


@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("form,G", SCAN_CASES)
def test_plain_scan_matches_jax_scan(form, G, T):
    args = _scan_inputs(form, G, T)
    st_ref, y_ref = _jax_scan(*(jnp.asarray(a) for a in args))
    state = torch.from_numpy(args[0].copy())
    y = ss.ssm_scan(state, *(torch.from_numpy(a) for a in args[1:]))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(st_ref), **TOL)


@pytest.mark.parametrize("form,G", [("mamba1", 1), ("mamba2", 2)])
def test_plain_scan_keeps_idle_rows(form, G):
    """An inactive row keeps its state and gets y 0; the others are JAX's."""
    args = _scan_inputs(form, G, 5, seed=1)
    st_ref, y_ref = _jax_scan(*(jnp.asarray(a) for a in args))
    active = torch.tensor([True, False, True])
    state = torch.from_numpy(args[0].copy())
    y = ss.ssm_scan(state, *(torch.from_numpy(a) for a in args[1:]), active=active)
    np.testing.assert_array_equal(state[1].numpy(), args[0][1])
    np.testing.assert_array_equal(y[1].numpy(), 0)
    for b in (0, 2):
        np.testing.assert_allclose(state[b].numpy(), np.asarray(st_ref)[b], **TOL)
        np.testing.assert_allclose(y[b].numpy(), np.asarray(y_ref)[b], **TOL)


def test_plain_scan_bf16_state_round_trip():
    """A bf16 state is read as f32 and written back rounded, as JAX casts."""
    args = _scan_inputs("mamba2", 2, 4, seed=2)
    st0 = torch.from_numpy(args[0]).to(torch.bfloat16)
    st_ref, _ = _jax_scan(jnp.asarray(st0.float().numpy()), *(jnp.asarray(a) for a in args[1:]))
    state = st0.clone()
    ss.ssm_scan(state, *(torch.from_numpy(a) for a in args[1:]))
    want = torch.from_numpy(np.array(st_ref)).to(torch.bfloat16)
    assert state.dtype == torch.bfloat16
    torch.testing.assert_close(state, want, rtol=0, atol=0)


# ------------------------------------------------------------------ mixers


def _hp(**kw):
    base = dict(arch="mamba", n_vocab=64, n_ctx_train=64, n_embd=32, n_layer=1, n_head=0,
                n_head_kv=0, n_ff=0, n_rot=0, head_dim=0, head_dim_v=0, ssm_d_conv=4)
    base.update(kw)
    extra = base.pop("extra", {})
    return JHParams(**base, extra=dict(extra)), HParams(**base, extra=dict(extra))


def _mixer_case(kind: str, seed: int = 0):
    """(JAX hparams, port hparams, layer numpy dict, mixer name)."""
    rng = _rng(seed)
    E, dc = 32, 4
    w = lambda *s, scale=None: _f(rng, *s, scale=scale or 0.7 * s[0] ** -0.5)
    norm = lambda n: (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    if kind.startswith("mamba1"):
        di, ds, rank = 48, 16, 4
        jhp, thp = _hp(ssm_d_inner=di, ssm_d_state=ds, ssm_dt_rank=rank,
                       extra={"ssm_dt_b_c_rms": True} if kind == "mamba1_rms" else {})
        layer = {"ssm_in": w(E, 2 * di), "ssm_conv1d": w(dc, di, scale=0.3),
                 "ssm_conv1d_b": w(di, scale=0.05), "ssm_x": w(di, rank + 2 * ds),
                 "ssm_dt": w(rank, di, scale=0.3), "ssm_dt_b": w(di, scale=0.3),
                 "ssm_a": -np.exp(w(di, ds, scale=0.5)), "ssm_d": w(di, scale=0.5),
                 "ssm_out": w(di, E)}
        if kind == "mamba1_jamba":
            layer.update(ssm_dt_norm=norm(rank), ssm_b_norm=norm(ds), ssm_c_norm=norm(ds))
        return jhp, thp, layer, "_mamba_mixer"
    if kind.startswith("mamba2"):
        di, ds, nh = 64, 16, 8
        G = 1 if "g1" in kind else 2
        jhp, thp = _hp(arch="mamba2", ssm_d_inner=di, ssm_d_state=ds, ssm_dt_rank=nh,
                       ssm_n_group=G)
        cd = di + 2 * G * ds
        layer = {"ssm_in": w(E, 2 * di + 2 * G * ds + nh), "ssm_conv1d": w(dc, cd, scale=0.3),
                 "ssm_conv1d_b": w(cd, scale=0.05), "ssm_dt_b": w(nh, scale=0.3),
                 "ssm_a": -np.exp(w(nh, 1, scale=0.5)), "ssm_d": w(nh, 1, scale=0.5),
                 "ssm_out": w(di, E)}
        if "norm" in kind:
            layer["ssm_norm"] = norm(G * (di // G)).reshape(G, di // G)
        return jhp, thp, layer, "_mamba2_mixer"
    di, ds, nh, dt_dim = 64, 8, 4, 64
    jhp, thp = _hp(arch="plamo2", ssm_d_inner=di, ssm_d_state=ds, ssm_dt_rank=nh)
    layer = {"ssm_in": w(E, 2 * di), "ssm_conv1d": w(dc, di, scale=0.3),
             "ssm_x": w(di, 2 * ds + dt_dim), "ssm_dt": w(dt_dim, nh, scale=0.1),
             "ssm_dt_b": w(nh, scale=0.3), "ssm_a": -np.exp(w(nh, scale=0.5)),
             "ssm_d": w(nh, scale=0.5), "ssm_out": w(di, E), "ssm_dt_norm": norm(dt_dim),
             "ssm_b_norm": norm(ds), "ssm_c_norm": norm(ds)}
    return jhp, thp, layer, "plamo2_mixer"


MIXERS = ["mamba1", "mamba1_jamba", "mamba1_rms", "mamba2_g1_norm", "mamba2_g2_norm",
          "mamba2_g2", "plamo2"]


def _states(thp, B, seed):
    rng = _rng(seed)
    return (_f(rng, B, thp.ssm_d_conv - 1, thp.ssm_conv_dim, scale=0.5),
            _f(rng, B, thp.ssm_d_inner, thp.ssm_d_state, scale=0.5))


@pytest.mark.parametrize("kind,T", [(k, 7) for k in MIXERS]
                         + [("mamba1", 1), ("mamba2_g2_norm", 1)])
def test_mixer_matches_jax(kind, T):
    jhp, thp, layer, name = _mixer_case(kind)
    B = 2
    x = _f(_rng(5), B, T, 32)
    conv, ssm = _states(thp, B, 6)
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    mixer = jax.jit(lambda lay, xs, c, st: getattr(jmamba, name)(lay, jhp, xs, c, st))
    out_r, conv_r, ssm_r = mixer(jl, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm))
    tl = {k: torch.from_numpy(v) for k, v in layer.items()}
    conv_t, ssm_t = torch.from_numpy(conv.copy()), torch.from_numpy(ssm.copy())
    out = getattr(tmamba, name)(tl, thp, torch.from_numpy(x), conv_t, ssm_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), **TOL)
    np.testing.assert_allclose(conv_t.numpy(), np.asarray(conv_r), **TOL)
    np.testing.assert_allclose(ssm_t.numpy(), np.asarray(ssm_r), **TOL)


@pytest.mark.parametrize("kind", ["mamba1_jamba", "mamba2_g2_norm", "plamo2"])
def test_prefill_then_steps_equals_one_prefill(kind):
    """A 12-token step then two 1-token steps carry the conv and SSM state
    into the same outputs and states as one 14-token step."""
    _, thp, layer, name = _mixer_case(kind, seed=3)
    tl = {k: torch.from_numpy(v) for k, v in layer.items()}
    fn = getattr(tmamba, name)
    x = torch.from_numpy(_f(_rng(7), 2, 14, 32))
    conv, ssm = (torch.from_numpy(a) for a in _states(thp, 2, 8))
    c1, s1 = conv.clone(), ssm.clone()
    whole = fn(tl, thp, x, c1, s1)
    c2, s2 = conv.clone(), ssm.clone()
    parts = [fn(tl, thp, x[:, a:b], c2, s2) for a, b in ((0, 12), (12, 13), (13, 14))]
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, **TOL)
    torch.testing.assert_close(c2, c1, **TOL)
    torch.testing.assert_close(s2, s1, **TOL)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2_g2_norm", "plamo2"])
def test_mixer_keeps_idle_rows_state(kind):
    """``active`` False: the row's conv and SSM state stay as they were,
    the other row's are those of the step without the flag."""
    _, thp, layer, name = _mixer_case(kind, seed=4)
    tl = {k: torch.from_numpy(v) for k, v in layer.items()}
    fn = getattr(tmamba, name)
    x = torch.from_numpy(_f(_rng(9), 2, 3, 32))
    conv, ssm = (torch.from_numpy(a) for a in _states(thp, 2, 10))
    c1, s1 = conv.clone(), ssm.clone()
    ref = fn(tl, thp, x, c1, s1)
    c2, s2 = conv.clone(), ssm.clone()
    got = fn(tl, thp, x, c2, s2, torch.tensor([True, False]))
    torch.testing.assert_close(c2[1], conv[1], rtol=0, atol=0)
    torch.testing.assert_close(s2[1], ssm[1], rtol=0, atol=0)
    torch.testing.assert_close(c2[0], c1[0], rtol=0, atol=0)
    torch.testing.assert_close(s2[0], s1[0], rtol=0, atol=0)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)


# ------------------------------------------------------------------ caches


def _rec_pair(seed=0, L=2, B=4):
    """A JAX RecurrentCache of random state and the port's copy of it."""
    rng = _rng(seed)
    conv, ssm = _f(rng, L, B, 3, 40), _f(rng, L, B, 24, 8)
    j = jrec.RecurrentCache(conv=jnp.asarray(conv), ssm=jnp.asarray(ssm))
    return j, convert.recurrent_cache_from_jax(j, device="cpu")


def _hybrid_hp():
    kw = dict(arch="jamba", n_vocab=64, n_ctx_train=64, n_embd=32, n_layer=4, n_head=4,
              n_head_kv=2, n_ff=64, n_rot=8, head_dim=8, head_dim_v=8, ssm_d_conv=4,
              ssm_d_inner=24, ssm_d_state=8, ssm_dt_rank=4, n_head_kv_arr=[0, 2, 0, 2])
    return JHParams(**kw), HParams(**kw)


def _hybrid_pair(seed=0, B=4, S=6):
    """A JAX HybridCache with random KV rows and state, and the port's copy."""
    jhp, _ = _hybrid_hp()
    c = jjamba.hybrid_cache_init(jhp, B, S)
    rng = _rng(seed)
    cursor = np.asarray([2, 5, 0, 4], np.int32)
    pos = np.where(np.arange(S)[None] < cursor[:, None], np.arange(S)[None], -1).astype(np.int32)
    attn = c.attn._replace(k=jnp.asarray(_f(rng, *c.attn.k.shape)),
                           v=jnp.asarray(_f(rng, *c.attn.v.shape)),
                           pos=jnp.asarray(pos), cursor=jnp.asarray(cursor))
    rec = jrec.RecurrentCache(conv=jnp.asarray(_f(rng, *c.rec.conv.shape)),
                              ssm=jnp.asarray(_f(rng, *c.rec.ssm.shape)))
    j = jrec.HybridCache(attn=attn, rec=rec)
    return j, convert.hybrid_cache_from_jax(jax.tree_util.tree_map(np.asarray, j), device="cpu")


def _assert_same(t, j):
    """A port cache equal to a JAX one (the KV spare slot aside)."""
    if isinstance(t, trec.HybridCache):
        S = t.attn.max_seq
        for f in ("k", "v"):
            np.testing.assert_array_equal(getattr(t.attn, f)[:, :, :, :S].numpy(),
                                          np.asarray(getattr(j.attn, f)))
        np.testing.assert_array_equal(t.attn.pos[:, :S].numpy(), np.asarray(j.attn.pos))
        np.testing.assert_array_equal(t.attn.cursor.numpy(), np.asarray(j.attn.cursor))
        t, j = t.rec, j.rec
    np.testing.assert_array_equal(t.conv.numpy(), np.asarray(j.conv))
    np.testing.assert_array_equal(t.ssm.numpy(), np.asarray(j.ssm))


@pytest.mark.parametrize("kind", ["recurrent", "hybrid"])
def test_mask_rows_matches_jax(kind):
    pair = _rec_pair if kind == "recurrent" else _hybrid_pair
    j_old, t_old = pair(0)
    j_new, t_new = pair(1)
    active = np.asarray([True, False, False, True])
    ref = jcp.mask_rows(j_new, j_old, jnp.asarray(active))
    got = tcp.mask_rows(t_new, t_old, torch.from_numpy(active))
    assert got is t_new
    _assert_same(got, ref)


@pytest.mark.parametrize("kind", ["recurrent", "hybrid"])
def test_truncate_rows_matches_jax(kind):
    """keep 0 resets a recurrent row, any other count keeps it; a hybrid
    cache also cuts its KV rows."""
    pair = _rec_pair if kind == "recurrent" else _hybrid_pair
    j, t = pair(2)
    keep = np.asarray([0, 3, 0, 1], np.int32)
    ref = jcp.truncate_rows(j, jnp.asarray(keep))
    got = tcp.truncate_rows(t, torch.from_numpy(keep))
    assert got is t
    _assert_same(got, ref)


def _assert_blob(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_blob(got[k], ref[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


@pytest.mark.parametrize("kind", ["recurrent", "hybrid"])
def test_get_row_matches_jax(kind):
    pair = _rec_pair if kind == "recurrent" else _hybrid_pair
    j, t = pair(3)
    for idx in (0, 3):
        _assert_blob(tcp.get_row(t, idx), jcp.get_row(j, idx))


@pytest.mark.parametrize("kind", ["recurrent", "hybrid"])
def test_set_row_of_jax_blob_matches_jax(kind):
    """The JAX package's get_row blob of one cache, set into row 1 of
    another, in both packages."""
    pair = _rec_pair if kind == "recurrent" else _hybrid_pair
    j_src, _ = pair(4)
    j_dst, t_dst = pair(5)
    blob = jcp.get_row(j_src, 3)
    ref = jcp.set_row(j_dst, 1, blob)
    got = tcp.set_row(t_dst, 1, blob)
    assert got is t_dst
    _assert_same(got, ref)


def test_set_row_refuses_a_state_of_another_shape():
    _, t = _rec_pair(6)
    blob = tcp.get_row(t, 0)
    with pytest.raises(ValueError, match="ssm"):
        tcp.set_row(t, 1, {"conv": blob["conv"], "ssm": blob["ssm"][:, :3]})
    with pytest.raises(ValueError, match="hybrid"):
        tcp.set_row(_hybrid_pair(7)[1], 0, blob)


@pytest.mark.parametrize("remaining,cap", [(1, 256), (2, 256), (3, 256), (12, 256),
                                           (255, 256), (256, 256), (257, 256), (1000, 256),
                                           (1000, 100), (5, 4)])
def test_pow2_chunk_matches_jax(remaining, cap):
    assert tcp.pow2_chunk(remaining, cap) == jcp.pow2_chunk(remaining, cap)


@pytest.mark.parametrize("kind", ["mamba", "mamba2", "hybrid"])
def test_make_cache_matches_jax(kind):
    """The memory by kind: shapes and types of the JAX package's (the port's
    KV cache has one spare slot more)."""
    if kind == "hybrid":
        jhp, thp = _hybrid_hp()
    else:
        jhp, thp = _hp(arch=kind, ssm_d_inner=48, ssm_d_state=16,
                       ssm_dt_rank=8 if kind == "mamba2" else 4,
                       ssm_n_group=2 if kind == "mamba2" else 0)
    ref = jcp.make_cache(jhp, 3, 16, jnp.bfloat16)
    got = tcp.make_cache(thp, 3, 16, torch.bfloat16)
    assert tcp.cache_kind(thp) == jcp.cache_kind(jhp)
    if kind == "hybrid":
        assert isinstance(got, trec.HybridCache)
        assert tuple(got.attn.k.shape) == ref.attn.k.shape[:3] + (17,) + ref.attn.k.shape[4:]
        ref, got = ref.rec, got.rec
    assert isinstance(got, trec.RecurrentCache)
    for f in ("conv", "ssm"):
        assert tuple(getattr(got, f).shape) == getattr(ref, f).shape
        assert getattr(got, f).dtype == torch.bfloat16


@pytest.mark.parametrize("kv", ["q8_0", "q4_0"])
def test_make_cache_refuses_quantized_recurrent_memory(kv):
    _, thp = _hybrid_hp()
    with pytest.raises(ValueError, match="q8_0 KV cache is supported"):
        tcp.make_cache(thp, 1, 16, kv)


def test_seq_keep_row_and_rwkv_cache_match_jax():
    """seq_keep_row zeroes every row but one (the JAX function's intent: its
    SSM mask drops the wrong axis and fails to broadcast, ROADMAP §3)."""
    j, t = _rec_pair(8)
    with pytest.raises(ValueError, match="broadcast"):
        jrec.seq_keep_row(j, 2)
    keep = (np.arange(4) == 2)[None, :, None, None]
    want = jrec.RecurrentCache(conv=np.where(keep, j.conv, 0), ssm=np.where(keep, j.ssm, 0))
    _assert_same(trec.seq_keep_row(t, 2), want)
    ref = jrec.rwkv_cache_init(2, 3, 32, 2, 16)
    got = trec.rwkv_cache_init(2, 3, 32, 2, 16)
    assert tuple(got.shift.shape) == ref.shift.shape and tuple(got.wkv.shape) == ref.wkv.shape
    assert got.wkv.dtype == torch.float32 and got.batch == 3


# ------------------------------------------------------------------ the kernel wrapper


@pytest.mark.parametrize("ds,split", [(1, (1, 1)), (8, (1, 8)), (16, (1, 16)), (64, (4, 16)),
                                      (128, (8, 16)), (512, (32, 16))])
def test_scan_split(ds, split):
    assert ss.scan_split(ds) == split


@pytest.mark.parametrize("ds", [24, 48, 1024])
def test_scan_split_refuses(ds):
    with pytest.raises(ValueError, match="d_state"):
        ss.scan_split(ds)


@pytest.fixture
def recorded(monkeypatch):
    """CUDA-typed tensors reach a recording stand-in for ssm_scan's C
    entry; torch.empty keeps them CUDA-typed; the plain version raises."""
    calls = []

    def slt_ssm_scan(*args):
        calls.append(args)
        return 0
    slt_ssm_scan.argtypes = None
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        slt_ssm_scan=slt_ssm_scan))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 7)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: cuda_typed(
        empty(*a, **{k: v for k, v in kw.items() if k != "device"})))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ss, "ssm_scan_plain", plain)
    return calls


def _cuda_inputs(form, G, T, dtype=torch.float32):
    args = [torch.from_numpy(a) for a in _scan_inputs(form, G, T, Bt=2)]
    args[0] = args[0].to(dtype)
    return [cuda_typed(a) for a in args]


@pytest.mark.parametrize("form,G,dtype,active", [
    ("mamba1", 1, torch.float32, False), ("mamba1", 1, torch.bfloat16, True),
    ("mamba2", 2, torch.bfloat16, False), ("mamba2", 4, torch.float32, True)])
def test_wrapper_launches_the_kernel_once(recorded, form, G, dtype, active):
    state, x, dt, A, Bm, Cm = _cuda_inputs(form, G, 3, dtype)
    act = cuda_typed(torch.tensor([True, False])) if active else None
    before = ss.ssm_scan.launches
    y = ss.ssm_scan(state, x, dt, A, Bm, Cm, act)
    assert ss.ssm_scan.launches == before + 1
    assert y.device.type == "cuda" and tuple(y.shape) == tuple(x.shape)
    assert y.dtype == torch.float32
    (c,) = recorded
    Bt, T, nh, hd = x.shape
    ds = Bm.shape[3]
    lanes, ns = ss.scan_split(ds)
    assert c[:11] == (Bt, T, nh, hd, ds, G, lanes, ns, int(form == "mamba1"),
                      int(dtype == torch.bfloat16), int(ns == 16))
    assert c[11] == state.data_ptr()
    assert (c[17] is None) == (not active)
    assert c[-1] == 7


def test_wrapper_refusals(recorded):
    state, x, dt, A, Bm, Cm = _cuda_inputs("mamba2", 2, 3)
    with pytest.raises(TypeError, match="f32 or bf16 state"):
        ss.ssm_scan(state.to(torch.float16), x, dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="shapes"):
        ss.ssm_scan(state, x, dt[:, :, :4], A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan(cuda_typed(state.transpose(2, 3).contiguous().transpose(2, 3)), x, dt,
                    A, Bm, Cm)
    assert not recorded


def test_wrapper_refuses_other_devices():
    args = [torch.from_numpy(a).to("meta") for a in _scan_inputs("mamba2", 1, 2)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.ssm_scan(*args)


def test_failed_build_raises(monkeypatch):
    err = failing_build(monkeypatch)
    with pytest.raises(err):
        ss.ssm_scan(*_cuda_inputs("mamba1", 1, 2))


def test_plain_route_launches_nothing():
    before = ss.ssm_scan.launches
    ss.ssm_scan(*(torch.from_numpy(a) for a in _scan_inputs("mamba2", 1, 2)))
    assert ss.ssm_scan.launches == before
