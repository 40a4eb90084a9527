"""Port parity: Q8_0 / Q4_0 KV caches (superllama_tpu_torch.runtime.kv_cache)
and the paths that run on them, against the JAX package.

 - cache codes and scales are bit-equal to the JAX package's (round half to
   even, Q4_0's clip to ±7 then +8), after in-place updates too;
 - the tiny model's forward on a quantized cache (materialized, through the
   split-KV decode kernel, and Q8_0 codes into prefill flash attention)
   gives the JAX package's logits;
 - the Engine's greedy tokens on a Q8_0 cache equal the JAX Engine's, and
   the CLI runs with ``--kv-dtype q8_0|q4_0``.

Tolerances: logits NMSE < 1e-6. The float parts of a step agree to f32
rounding (the packages' matmuls sum in other orders), and where a K or V
value sits at a rounding boundary of the code grid that moves its code by
one step: one such flip measured 3e-8 on the Q8_0 materialized path; with
identical codes the logits agree to about 1e-13. The JAX side of a step
that reaches a Pallas kernel in interpret mode runs with XLA's excess
precision off (``xla_exact``), so its bf16 roundings happen as written.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.models.llama import llama_forward as jax_forward
from superllama_tpu.runtime import kv_cache as JK
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch.convert import kv_cache_from_jax
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models.llama import llama_forward
from superllama_tpu_torch.runtime import kv_cache as TK
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from test_torch_fixtures import prompt, write_tiny_llama

GREEDY = {"greedy": True}
QUANTIZE = {"q8_0": (JK.q8_quantize_rows, TK.q8_quantize_rows),
            "q4_0": (JK.q4_quantize_rows, TK.q4_quantize_rows)}


def _np(a):
    return np.asarray(a)


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


# ------------------------------------------------------------ codes


def _rows(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "ties":
        # values at exact .5 steps of the code grid (amax 127, resp. 7 per
        # 32-group): round half to even decides them
        base = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] * 8, np.float32)
        return np.stack([base, base * (7 / 127)])
    if case == "zeros":
        x = rng.normal(0, 1, (3, 64)).astype(np.float32)
        x[1] = 0.0
        x[2, :32] = 0.0                   # one all-zero Q4_0 group
        return x
    return rng.normal(0, 2, (2, 3, 5, 128)).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("kvt", ["q8_0", "q4_0"])
def test_quantize_rows_bit_equal(kvt, case):
    jq, tq = QUANTIZE[kvt]
    x = _rows(case)
    jc, js = jq(jnp.asarray(x))
    tc, ts = tq(torch.from_numpy(x))
    assert tc.dtype == (torch.int8 if kvt == "q8_0" else torch.uint8)
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


def test_q4_dequant_matches_jax():
    x = _rows("normal")
    jc, js = JK.q4_quantize_rows(jnp.asarray(x))
    got = TK.q4_dequant(torch.from_numpy(_np(jc)), torch.from_numpy(_np(js)))
    np.testing.assert_array_equal(got.numpy(), _np(JK.q4_dequant(jc, js)))


def _fill(kvt, L=2, B=3, S=16, Hkv=2, D=64):
    """The same write sequence (prefill, padded rows, decode) through the
    JAX functional update and the port's in-place one."""
    rng = np.random.default_rng(7)
    jc = JK.kv_cache_init(L, B, S, Hkv, D, dtype=kvt)
    tc = TK.kv_cache_init(L, B, S, Hkv, D, dtype=kvt)
    for T, pos in ((5, [[0, 1, 2, 3, 4], [0, 1, 2, -1, -1], [0, 1, 2, 3, -1]]),
                   (1, [[5], [3], [-1]])):
        pos = np.asarray(pos, np.int32)[:B]
        js, ts = JK.kv_write_slots(jc, T), TK.kv_write_slots(tc, T)
        jc = JK.kv_advance(jc, js, jnp.asarray(pos))
        TK.kv_advance(tc, ts, torch.from_numpy(pos))
        for il in range(L):
            kn = rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)
            vn = rng.normal(0, 1, (B, T, Hkv, D)).astype(np.float32)
            jc = JK.kv_update_layer(jc, il, js, jnp.asarray(kn), jnp.asarray(vn))
            assert TK.kv_update_layer(tc, il, ts, torch.from_numpy(kn),
                                      torch.from_numpy(vn)) is tc
    return jc, tc


@pytest.mark.parametrize("kvt", ["q8_0", "q4_0"])
def test_update_in_place_matches_jax(kvt):
    jc, tc = _fill(kvt)
    assert tc.quantized and tc.q4 == (kvt == "q4_0")
    S = jc.max_seq
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name)[:, :, :, :S].numpy(),
                                      _np(getattr(jc, name)))
    np.testing.assert_array_equal(tc.positions().numpy(), _np(jc.pos))
    for il in range(2):
        for got, ref in zip(TK.kv_layer(tc, il), JK.kv_layer(jc, il)):
            np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize("kvt", ["q8_0", "q4_0"])
def test_insert_and_truncate_carry_scales(kvt):
    _, small = _fill(kvt, B=1)
    big = TK.kv_cache_init(2, 3, 16, 2, 64, dtype=kvt)
    TK.kv_insert_row(big, small, 1, 5)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(big, name)[:, 1], getattr(small, name)[:, 0])
        assert not getattr(big, name)[:, 0].any()
    TK.kv_truncate_rows(big, torch.tensor([0, 3, 0]))
    assert big.cursor.tolist() == [0, 3, 0]
    assert (big.positions()[1, 3:] == -1).all() and big.positions()[1, :3].tolist() == [0, 1, 2]
    k, v = TK.kv_layer(big, 0)
    ks, vs = TK.kv_layer(small, 0)
    assert torch.equal(k[1], ks[0]) and torch.equal(v[1], vs[0])


@pytest.mark.parametrize("kvt", ["float32", "q8_0", "q4_0"])
def test_kv_cache_from_jax_adds_spare_slot(kvt):
    dt = jnp.float32 if kvt == "float32" else kvt
    jc = JK.kv_cache_init(2, 2, 8, 2, 64, dtype=dt)
    rng = np.random.default_rng(1)
    slots = JK.kv_write_slots(jc, 3)
    jc = JK.kv_advance(jc, slots, jnp.asarray([[0, 1, 2], [0, -1, -1]], jnp.int32))
    jc = JK.kv_update_layer(jc, 1, slots, jnp.asarray(rng.normal(0, 1, (2, 3, 2, 64)),
                                                      jnp.float32),
                            jnp.asarray(rng.normal(0, 1, (2, 3, 2, 64)), jnp.float32))
    tc = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert tc.max_seq == 8 and tc.quantized == (kvt != "float32")
    for name in ("k", "v") + (("k_scale", "v_scale") if tc.quantized else ()):
        got = getattr(tc, name)
        np.testing.assert_array_equal(got[:, :, :, :8].numpy(), _np(getattr(jc, name)))
        assert not got[:, :, :, 8].any()
    np.testing.assert_array_equal(tc.positions().numpy(), _np(jc.pos))
    assert (tc.pos[:, 8] == -1).all() and tc.cursor.tolist() == [3, 1]


def test_kv_cache_init_rejects_unknown_types():
    with pytest.raises(ValueError):
        TK.kv_cache_init(1, 1, 8, 1, 64, dtype="q5_1")
    with pytest.raises(ValueError):
        TK.kv_cache_init(1, 1, 8, 1, 48, dtype="q4_0")


# ------------------------------------------------------------ forward


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("kvq"), (GGMLType.F32,))[GGMLType.F32]


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jmodel(path):
    return jax_load(path)


class _JaxSteps:
    """The JAX forward, jitted per input shape with excess precision off."""

    def __init__(self, jm, flash):
        self.jm, self.flash, self.compiled = jm, flash, {}

    def __call__(self, tokens, pos, cache, flash=None):
        key = (tokens.shape, flash)
        if key not in self.compiled:
            fn = jax.jit(lambda t, p, c: jax_forward(self.jm.params, self.jm.hparams, t, p, c,
                                                     flash=flash))
            self.compiled[key] = fn.lower(tokens, pos, cache).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return self.compiled[key](tokens, pos, cache)


MODES = {
    "materialize": {},
    "flash_decode": {"flash_decode": True},
    "flash_decode_float": {"flash_decode": True, "flash_decode_float": True},
}


def _run(model, jmodel, kvt, extra, prefill_flash, ids, n_decode=5):
    """1 prefill + n_decode greedy steps through both packages from empty
    caches; returns [(port logits, JAX logits)] per step."""
    hp, jhp = model.hparams, jmodel.hparams
    for h in (hp, jhp):
        h.extra.update(extra)
    try:
        steps = _JaxSteps(jmodel, None)
        jc = JK.kv_cache_init(jhp.n_layer, 1, 64, jhp.n_head_kv, jhp.head_dim,
                              jhp.head_dim_v, dtype=kvt)
        tc = TK.kv_cache_init(hp.n_layer, 1, 64, hp.n_head_kv, hp.head_dim,
                              hp.head_dim_v, dtype=kvt)
        out, toks, p0 = [], list(ids), 0
        with torch.no_grad():
            for i in range(n_decode + 1):
                chunk = toks if i == 0 else [nxt]
                t = np.asarray([chunk], np.int32)
                p = np.arange(p0, p0 + len(chunk), dtype=np.int32)[None]
                flash = prefill_flash if i == 0 else None
                jl, jc = steps(jnp.asarray(t), jnp.asarray(p), jc, flash=flash)
                tl, _ = llama_forward(model.params, hp, torch.from_numpy(t).long(),
                                      torch.from_numpy(p), tc, flash=flash)
                out.append((tl[0, -1].numpy(), np.asarray(jl[0, -1], np.float32)))
                nxt = int(np.argmax(out[-1][1]))
                p0 += len(chunk)
    finally:
        for h in (hp, jhp):
            for key in extra:
                h.extra.pop(key, None)
    return out


@pytest.mark.parametrize("kvt,mode,prefill_flash", [
    ("q8_0", "materialize", None), ("q8_0", "flash_decode", None),
    ("q8_0", "flash_decode", True), ("q4_0", "materialize", None),
    ("q4_0", "flash_decode_float", None), ("q4_0", "materialize", True)],
    ids=["q8-materialize", "q8-fd", "q8-fd-flash-prefill", "q4-materialize",
         "q4-fd-float", "q4-flash-prefill"])
def test_forward_matches_jax(model, jmodel, kvt, mode, prefill_flash):
    ids = prompt(11, 4)
    for i, (got, ref) in enumerate(_run(model, jmodel, kvt, MODES[mode], prefill_flash, ids)):
        assert np.isfinite(got).all()
        assert _nmse(got, ref) < 1e-6, (i, _nmse(got, ref))


def test_decode_from_a_jax_state(model, jmodel):
    """Both packages continue one mid-generation Q8_0 state (the JAX
    prefill, carried over by kv_cache_from_jax) through the decode kernel."""
    hp, jhp = model.hparams, jmodel.hparams
    ids = prompt(9, 8)
    jc = JK.kv_cache_init(jhp.n_layer, 1, 32, jhp.n_head_kv, jhp.head_dim, dtype="q8_0")
    t = jnp.asarray([ids], jnp.int32)
    _, jc = jax_forward(jmodel.params, jhp, t, jnp.arange(9, dtype=jnp.int32)[None], jc)
    tc = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    for h in (hp, jhp):
        h.extra["flash_decode"] = True
    try:
        for i, tok in enumerate((5, 77, 200)):
            p = np.asarray([[9 + i]], np.int32)
            jl, jc = jax_forward(jmodel.params, jhp, jnp.asarray([[tok]], jnp.int32),
                                 jnp.asarray(p), jc)
            with torch.no_grad():
                tl, _ = llama_forward(model.params, hp, torch.tensor([[tok]]),
                                      torch.from_numpy(p), tc)
            assert _nmse(tl[0, -1].numpy(), np.asarray(jl[0, -1], np.float32)) < 1e-6
    finally:
        for h in (hp, jhp):
            h.extra.pop("flash_decode", None)


# ------------------------------------------------------------ engine, CLI


@pytest.mark.parametrize("n_prompt", [5, 40, 150], ids=lambda n: f"p{n}")
def test_engine_q8_matches_jax(jmodel, model, n_prompt):
    """A lone prompt prefills into a Q8_0 scratch cache inserted with its
    scales; 150 tokens load in two chunks (128 + 22)."""
    p = prompt(n_prompt, n_prompt)
    ref = JaxEngine(jmodel, n_slots=3, n_ctx=256, kv_dtype="q8_0").generate(
        p, max_tokens=12, sampling=GREEDY, stop_eog=False)
    got = Engine(model, n_slots=3, n_ctx=256, kv_dtype="q8_0", device="cpu").generate(
        p, max_tokens=12, sampling=GREEDY, stop_eog=False)
    assert got["tokens"] == ref["tokens"]


def test_engine_q4_wave_matches_jax(jmodel, model):
    """Two prompts load in one in-place wave. (The JAX Engine cannot insert
    a lone prompt's Q4_0 scratch cache, so this is the Q4_0 comparison.)"""
    prompts = [prompt(9, 5), prompt(40, 6)]
    je = JaxEngine(jmodel, n_slots=3, n_ctx=256, kv_dtype="q4_0")
    jr = [je.submit(JaxRequest(prompt_ids=p, max_tokens=10, sampling=GREEDY,
                               stop_eog=False)) for p in prompts]
    je.run_until_drained()
    eng = Engine(model, n_slots=3, n_ctx=256, kv_dtype="q4_0", device="cpu")
    tr = [eng.submit(GenRequest(prompt_ids=p, max_tokens=10, sampling=GREEDY,
                                stop_eog=False)) for p in prompts]
    eng.run_until_drained()
    assert [r.result()["tokens"] for r in tr] == [r.result()["tokens"] for r in jr]


@pytest.mark.parametrize("kvt", ["q8_0", "q4_0"])
def test_quantized_block_decode_equals_step_decode(model, kvt):
    """11 tokens stop mid-block: the overshoot rolls back on the quantized
    cache, and the lone prompt's scratch is inserted with its scales."""
    p = prompt(9, 7)
    kw = dict(n_slots=2, n_ctx=128, kv_dtype=kvt, device="cpu")
    block = Engine(model, block_size=8, **kw)
    step = Engine(model, block_size=1, **kw)
    a = [block.generate(p, max_tokens=11, sampling=GREEDY, stop_eog=False)["tokens"]
         for _ in range(2)]
    b = step.generate(p, max_tokens=11, sampling=GREEDY, stop_eog=False)["tokens"]
    assert a[0] == a[1] == b and len(b) == 11


def test_context_q8_greedy_matches_jax(jmodel, model):
    from superllama_tpu.runtime.context import Context as JaxContext
    from superllama_tpu_torch.runtime.context import Context

    ids = prompt(12, 9)
    ref = JaxContext(jmodel, n_batch=1, n_ctx=64, kv_dtype="q8_0").greedy_generate(
        ids, 8, stop_eog=False)
    got = Context(model, n_batch=1, n_ctx=64, kv_dtype="q8_0",
                  device="cpu").greedy_generate(ids, 8, stop_eog=False)
    assert got == ref


def test_server_app_q8_completion(model):
    """A completion through ServerApp on a Q8_0 cache gives the engine's
    tokens."""
    from superllama_tpu_torch.server.http import ServerApp

    p = prompt(10, 13)
    app = ServerApp(model, n_slots=2, n_ctx=128, kv_dtype="q8_0", device="cpu")
    app.engine.start()
    try:
        out = app.handle_completion({"prompt": p, "max_tokens": 6, "temperature": 0,
                                     "return_tokens": True})
    finally:
        app.engine.stop()
    ref = Engine(model, n_slots=2, n_ctx=128, kv_dtype="q8_0", device="cpu").generate(
        p, max_tokens=6, sampling=GREEDY)
    assert out["choices"][0]["tokens"] == ref["tokens"]


@pytest.mark.parametrize("kvt", ["q8_0", "q4_0"])
def test_cli_run_quantized_kv(path, capsys, kvt):
    from superllama_tpu_torch.cli import main

    rc = main(["run", "-m", path, "-p", "hello", "-n", "4", "--temp", "0",
               "--device", "cpu", "--kv-dtype", kvt])
    assert rc == 0
    assert "4 tokens" in capsys.readouterr().err
