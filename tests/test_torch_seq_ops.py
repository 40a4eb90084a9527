"""The port's KV sequence ops and context shift (``runtime/kv_cache.py``)
against the JAX package's, on the CPU:

 - every op (seq_rm, seq_add, seq_add_rerope, seq_div, seq_cp, seq_keep,
   kv_gather_slots, kv_context_shift) on f32, bf16 and Q8_0 caches built
   from the same numpy-seeded K/V: positions and cursors equal, V (and V
   scales) bit-equal, K within one bf16 step (bf16), 1e-6 (f32) or one code
   with scales to 1e-6 (Q8_0): torch's and XLA's cos / sin may part by an
   ulp;
 - the shift equals re-encoding: the shifted K equals raw K roped at the
   new positions (the JAX test's check, on the port);
 - a Q4_0 cache: the JAX package's re-rope fails, the port's raises
   ValueError, and an Engine with ctx_shift refuses it;
 - every op writes in place: the cache's tensors keep their storage;
 - the paged shift (export, dense shift, import) against the JAX package's
   on the same page chains, closed-page gaps included.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.ops import jnp_ref as jops
from superllama_tpu.runtime import kv_cache as jkv
from superllama_tpu.runtime import paged_kv as jpkv
from superllama_tpu_torch.ops import ref as tops
from superllama_tpu_torch.runtime import kv_cache as tkv
from superllama_tpu_torch.runtime import paged_kv as tpkv
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

L, B, HKV, S, D = 2, 2, 2, 32, 32
N0 = 20
KINDS = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
         "q8_0": ("q8_0", "q8_0")}


def _raw(seed: int = 0):
    rng = np.random.default_rng(seed)
    k = rng.normal(0, 1, (L, B, N0, HKV, D)).astype(np.float32)
    v = rng.normal(0, 1, (L, B, N0, HKV, D)).astype(np.float32)
    return k, v


def _positions() -> np.ndarray:
    """Row 0 at 0..N0-1; row 1 at 0..N0-1 with position 7 missing (a hole
    after seq_rm) and the rest one later."""
    pos = np.tile(np.arange(N0, dtype=np.int32), (B, 1))
    pos[1, 7:] += 1
    return pos


def _rope():
    return (jops.rope_frequencies(D, D, 10000.0), tops.rope_frequencies(D, D, 10000.0))


def caches(kind: str):
    """(port cache, JAX cache) holding the same roped K and raw V."""
    tdt, jdt = KINDS[kind]
    raw_k, raw_v = _raw()
    pos = _positions()
    (jf, jms), (tf, tms) = _rope()
    tc = tkv.kv_cache_init(L, B, S, HKV, D, D, dtype=tdt)
    jc = jkv.kv_cache_init(L, B, S, HKV, D, D, dtype=jdt)
    tslots = tkv.kv_write_slots(tc, N0)
    jslots = jkv.kv_write_slots(jc, N0)
    tkv.kv_advance(tc, tslots, torch.from_numpy(pos))
    jc = jkv.kv_advance(jc, jslots, jnp.asarray(pos))
    for il in range(L):
        tk = tops.apply_rope(torch.from_numpy(raw_k[il]), torch.from_numpy(pos), tf, 0, tms)
        jk = jops.apply_rope(jnp.asarray(raw_k[il]), jnp.asarray(pos), jf, 0, jms)
        tkv.kv_update_layer(tc, il, tslots, tk, torch.from_numpy(raw_v[il]))
        jc = jkv.kv_update_layer(jc, il, jslots, jk, jnp.asarray(raw_v[il]))
    return tc, jc


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
                      else x)


def assert_caches_match(tc, jc, kind: str) -> None:
    np.testing.assert_array_equal(_np(tc.pos[:, :S]), _np(jc.pos))
    np.testing.assert_array_equal(_np(tc.cursor), _np(jc.cursor))
    np.testing.assert_array_equal(_np(tc.v[:, :, :, :S]), _np(jc.v))
    tk, jk = _np(tc.k[:, :, :, :S]), _np(jc.k)
    if kind == "q8_0":
        assert np.abs(tk.astype(np.int32) - jk.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(_np(tc.k_scale[:, :, :, :S]), _np(jc.k_scale), rtol=1e-6)
        np.testing.assert_array_equal(_np(tc.v_scale[:, :, :, :S]), _np(jc.v_scale))
    elif kind == "bf16":
        np.testing.assert_allclose(tk, jk, rtol=2 ** -8, atol=1e-6)
    else:
        np.testing.assert_allclose(tk, jk, rtol=1e-6, atol=1e-6)


def _gather_idx() -> tuple[np.ndarray, np.ndarray]:
    idx = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    idx[0, 5:9] = [12, 3, 17, 0]
    idx[1, :6] = idx[1, :6][::-1]
    return idx, np.asarray([9, 14], np.int32)


def _ops(mod, fr):
    """name -> fn(cache) returning the cache, for one package (mod, (inv_freq,
    mscale))."""
    f, ms = fr
    idx, nv = _gather_idx()
    arr = (lambda a: torch.from_numpy(a)) if mod is tkv else jnp.asarray
    return {
        "seq_rm": lambda c: mod.seq_rm(c, 1, 5, 9),
        "seq_add": lambda c: mod.seq_add(c, 0, 4, 12, 3),
        "seq_add_rerope": lambda c: mod.seq_add_rerope(c, 0, 4, 20, -2, f, 0, ms),
        "seq_div": lambda c: mod.seq_div(c, 1, 2, 18, 2, f, 0, ms),
        "seq_cp": lambda c: mod.seq_cp(c, 0, 1),
        "seq_keep": lambda c: mod.seq_keep(c, 1),
        "kv_gather_slots": lambda c: mod.kv_gather_slots(c, arr(idx), arr(nv)),
        # row 1 keeps its cells (discard 0)
        "kv_context_shift": lambda c: mod.kv_context_shift(
            c, arr(np.asarray([4, 6], np.int32)), arr(np.asarray([8, 0], np.int32)), f, 0, ms),
    }


OPS = list(_ops(tkv, (None, 1.0)))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_seq_op_matches_jax(kind, op):
    (jf, jms), (tf, tms) = _rope()
    tc, jc = caches(kind)
    out = _ops(tkv, (tf, tms))[op](tc)
    assert out is tc
    jc = _ops(jkv, (jf, jms))[op](jc)
    assert_caches_match(tc, jc, kind)


def test_context_shift_two_rows_matches_jax():
    """Both rows shifted, by different amounts (the engine's case of two
    slots passing n_ctx in one step)."""
    (jf, jms), (tf, tms) = _rope()
    tc, jc = caches("f32")
    keep, discard = np.asarray([2, 5], np.int32), np.asarray([9, 3], np.int32)
    tkv.kv_context_shift(tc, torch.from_numpy(keep), torch.from_numpy(discard), tf, 0, tms)
    jc = jkv.kv_context_shift(jc, jnp.asarray(keep), jnp.asarray(discard), jf, 0, jms)
    assert_caches_match(tc, jc, "f32")


def test_shift_equivalent_to_reencoding():
    """Shifted K == raw K roped at the shifted positions (row 0: no holes)."""
    _, (tf, tms) = _rope()
    raw_k, raw_v = _raw()
    tc, _ = caches("f32")
    keep, discard = 4, 8
    tkv.kv_context_shift(tc, torch.tensor([keep, 0]), torch.tensor([discard, 0]), tf, 0, tms)
    kept = np.concatenate([np.arange(keep), np.arange(keep + discard, N0)])
    new_pos = np.arange(len(kept))
    n = len(kept)
    assert int(tc.cursor[0]) == n
    np.testing.assert_array_equal(tc.pos[0, :n].numpy(), new_pos)
    assert (tc.pos[0, n:S] == -1).all()
    for il in range(L):
        ref = tops.apply_rope(torch.from_numpy(raw_k[il, 0][kept][None]),
                              torch.from_numpy(new_pos[None]), tf, 0, tms)[0]
        got = tc.k[il, 0, :, :n].transpose(0, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tc.v[il, 0, :, :n].transpose(0, 1).numpy(),
                                      raw_v[il, 0][kept])


def test_q4_0_rerope_refused():
    """The JAX package's re-rope of a Q4_0 K fails (Q8_0's per-row scale
    broadcast over Q4_0's per-group scales); the port raises ValueError,
    and an Engine with ctx_shift refuses a Q4_0 cache at construction."""
    from superllama_tpu_torch.models.loader import LoadedModel
    from superllama_tpu_torch.models.synthetic import tiny_test_hparams
    from superllama_tpu_torch.runtime.engine import Engine

    (jf, jms), (tf, tms) = _rope()
    jc = jkv.kv_cache_init(L, B, S, HKV, D, D, dtype="q4_0")
    jc = jkv.kv_advance(jc, jkv.kv_write_slots(jc, 4), jnp.asarray(_positions()[:, :4]))
    with pytest.raises(Exception):
        jkv.kv_context_shift(jc, jnp.asarray([1, 1]), jnp.asarray([2, 2]), jf, 0, jms)
    tc = tkv.kv_cache_init(L, B, S, HKV, D, D, dtype="q4_0")
    for fn in (lambda: tkv.kv_context_shift(tc, torch.tensor([1, 1]), torch.tensor([2, 2]),
                                            tf, 0, tms),
               lambda: tkv.seq_div(tc, 0, 0, 4, 2, tf, 0, tms),
               lambda: tkv.seq_add_rerope(tc, 0, 0, 4, 1, tf, 0, tms)):
        with pytest.raises(ValueError, match="Q4_0"):
            fn()
    hp = tiny_test_hparams(head_dim=32, n_embd=128, n_rot=32)
    model = LoadedModel(hp, {"token_embd": torch.zeros(hp.n_vocab, hp.n_embd)},
                        tokenizer=None, metadata={})
    with pytest.raises(ValueError, match="Q4_0"):
        Engine(model, kv_dtype="q4_0", ctx_shift=True, device="cpu")


def _storage(c) -> list[int]:
    ts = [c.k, c.v, c.pos, c.cursor] + ([c.k_scale, c.v_scale] if c.quantized else [])
    return [t.data_ptr() for t in ts]


@pytest.mark.parametrize("op", OPS)
def test_ops_write_in_place(op):
    """Each op leaves the cache's tensors where they were (captured CUDA
    graphs address them), the spare slot untouched."""
    _, fr = _rope()
    tc, _ = caches("q8_0")
    before = _storage(tc)
    spare = (tc.k[:, :, :, S].clone(), tc.pos[:, S].clone())
    _ops(tkv, fr)[op](tc)
    assert _storage(tc) == before
    assert torch.equal(tc.k[:, :, :, S], spare[0]) and torch.equal(tc.pos[:, S], spare[1])


# ------------------------------------------------------------------ paged

PS, NPAGES, MAXP = 8, 12, 5


def paged_pair(seed: int = 3):
    """(port manager, JAX manager) with seq 0 holding 27 cells written in
    steps of 5, 6 (a fresh page: a 3-cell gap), 8 (a 2-cell gap), 3 and 5
    tokens, from the same numpy K/V: 4 pages."""
    rng = np.random.default_rng(seed)
    tm = tpkv.PagedKVManager(tpkv.paged_cache_init(L, NPAGES, PS, 2, MAXP, HKV, D, D,
                                                   dtype=torch.float32))
    jm = jpkv.PagedKVManager(jpkv.paged_cache_init(L, NPAGES, PS, 2, MAXP, HKV, D, D,
                                                   dtype=jnp.float32))
    p0 = 0
    for n in (5, 6, 8, 3, 5):
        pos = np.full((2, n), -1, np.int32)
        pos[0] = np.arange(p0, p0 + n)
        p0 += n
        k = rng.normal(0, 1, (L, 2, n, HKV, D)).astype(np.float32)
        v = rng.normal(0, 1, (L, 2, n, HKV, D)).astype(np.float32)
        for mgr, mod, arr in ((tm, tpkv, torch.from_numpy), (jm, jpkv, jnp.asarray)):
            mgr.plan_step({0: n})
            if mod is tpkv:
                slots, offs = mod.paged_advance(mgr.cache, arr(pos))
                for il in range(L):
                    mod.paged_update_layer(mgr.cache, il, slots, offs, arr(k[il]), arr(v[il]))
                mgr.finish_step()
            else:
                cache, slots, offs = mod.paged_advance(mgr.cache, arr(pos))
                for il in range(L):
                    cache = mod.paged_update_layer(cache, il, slots, offs, arr(k[il]),
                                                   arr(v[il]))
                mgr.finish_step(cache)
    return tm, jm


def test_paged_shift_matches_jax():
    """The port engine's paged shift (``Engine._paged_shift``: export the
    chain, shift a dense row, import the valid cells) against the JAX
    engine's (``_maybe_paged_context_shift``) on the same chain: the new
    chain's cells, positions and cursors equal."""
    from superllama_tpu.models.loader import LoadedModel as JLoaded
    from superllama_tpu.models.synthetic import tiny_test_hparams as jtiny
    from superllama_tpu.runtime.engine import Engine as JaxEngine
    from superllama_tpu.runtime.engine import SlotState as JState
    from superllama_tpu_torch.models.loader import LoadedModel
    from superllama_tpu_torch.models.synthetic import tiny_test_hparams
    from superllama_tpu_torch.runtime.engine import Engine, SlotState

    kw = dict(n_embd=HKV * D * 2, n_head=4, n_head_kv=HKV, head_dim=D, head_dim_v=D,
              n_rot=D, n_layer=L, rope_freq_base=10000.0)
    n_ctx = 32
    tm, jm = paged_pair()
    te = Engine(LoadedModel(tiny_test_hparams(**kw), {"token_embd": torch.zeros(1, 1)},
                            tokenizer=None, metadata={}),
                n_slots=2, n_ctx=n_ctx, kv_dtype=torch.float32, paged=True, page_size=PS,
                n_pages=NPAGES, max_pages_per_seq=MAXP, device="cpu", ctx_shift=True)
    je = JaxEngine(JLoaded(hparams=jtiny(**kw), params={}, tokenizer=None, metadata={}),
                   n_slots=2, n_ctx=n_ctx, kv_dtype=jnp.float32, paged=True, page_size=PS,
                   n_pages=NPAGES, max_pages_per_seq=MAXP, ctx_shift=True)
    te.pkv, je.pkv = tm, jm
    # the host counts of a slot about to pass n_ctx (the chain's 27 cells
    # stand for its positions)
    for eng, state in ((te, SlotState), (je, JState)):
        s = eng.slots[0]
        s.state, s.n_past, s.n_prompt = state.GENERATING, n_ctx - 1, 6
        s.cache_tokens = list(range(n_ctx - 1))
    n_keep, n_discard = te._shift_plan(te.slots[0])
    assert (n_keep, n_discard) == (6, 12)
    te._paged_shift(te.slots[0], n_keep, n_discard)
    je._maybe_paged_context_shift([je.slots[0]])
    tk, tv, tp = tm.export_row(0)
    jk, jv, jp = jm.export_row(0)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(tk.numpy(), jk, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert tm.save_cursor(0) == jm.save_cursor(0)
    assert int((tp >= 0).sum()) == 27 - n_discard
