"""The port's device sampler against the JAX package's, on the CPU.

 - threefry: ``fold_in``, ``split`` and ``uniform`` bits equal
   ``jax.random``'s for several seeds and counts (bit-exact);
 - ``chain_params`` / ``chain_supported`` equal the JAX package's, field by
   field;
 - ``chain_step_core`` given the uniforms that ``jax.random`` draws from the
   row keys, and ``chain_step`` drawing them itself, give the JAX
   ``chain_step``'s tokens and ring exactly, on tie-free (B, 260) logits for
   each stage of the chain;
 - ``sample`` (DecodeLoop's sampler) equals the JAX ``sample`` on one key.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.ops import device_sampling as jds
from superllama_tpu_torch.ops import device_sampling as tds

V = 260
B = 6
SEEDS = [0, 1, 42, 2**31 - 1, 123456789012]
COUNTS = [0, 1, 7, 1000, 2**31 + 5, 2**32 - 1]

CHAIN_CFGS = {
    "greedy": {"greedy": True},
    "temp": {"temp": 0.8, "top_k": 0, "top_p": 1.0, "min_p": 0.0},
    "top_k_p": {"temp": 0.9, "top_k": 20, "top_p": 0.9, "min_p": 0.0},
    "min_p": {"temp": 1.1, "top_k": 0, "top_p": 1.0, "min_p": 0.1},
    "typical": {"temp": 0.9, "typical_p": 0.7},
    "xtc": {"temp": 0.9, "xtc_probability": 0.7, "xtc_threshold": 0.02, "top_k": 60,
            "min_p": 0.0, "top_p": 1.0},
    "dynatemp": {"temp": 0.9, "dynatemp_range": 0.5, "dynatemp_exponent": 1.5},
    "top_n_sigma": {"temp": 0.8, "top_n_sigma": 1.0},
    "penalties": {"temp": 0.8, "penalty_repeat": 1.3, "penalty_freq": 0.2,
                  "penalty_present": 0.3, "penalty_last_n": 16},
    "bias": {"temp": 0.7, "logit_bias": {5: 3.0, 17: -2.0, 100: 5.0, 999: 1.0}},
}


def _key(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_match_jax(seed):
    key = _key(seed)
    for c in COUNTS:
        jk = np.asarray(jax.random.fold_in(jnp.asarray(key), c))
        tk = tds.fold_in(_t(key), c).numpy()
        assert np.array_equal(jk.astype(np.int64), tk), (seed, c)
        # the same fold through a tensor of counts
        assert np.array_equal(tds.fold_in(_t(key)[None], torch.tensor([c]))[0].numpy(), tk)
        for shape, lo, hi in (((), 0.0, 1.0), ((128,), 1e-7, 1.0 - 1e-7),
                              ((3000,), float(np.finfo(np.float32).tiny), 1.0)):
            ju = np.asarray(jax.random.uniform(jnp.asarray(jk), shape, jnp.float32, lo, hi))
            tu = tds.uniform(_t(jk), shape[0] if shape else None, lo, hi).numpy()
            assert ju.dtype == tu.dtype == np.float32
            assert np.array_equal(ju, tu), (seed, c, shape)
    js = np.asarray(jax.random.split(jnp.asarray(key)))
    assert np.array_equal(js.astype(np.int64), tds.split(_t(key)).numpy())


def test_chain_noise_matches_per_step_keys():
    """chain_noise draws a block's uniforms at once: step i of row b from
    fold_in(keys[b], counts[b] + i), as the JAX block does step by step."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, (3, 2), dtype=np.uint64).astype(np.uint32)
    counts = np.array([0, 5, 2**31], np.int64)
    u_xtc, u_g = tds.chain_noise(_t(keys), torch.from_numpy(counts), 4)
    for i in range(4):
        k = np.asarray(jax.vmap(jax.random.fold_in)(
            jnp.asarray(keys), jnp.asarray((counts + i).astype(np.uint32))))
        jx = np.asarray(jax.vmap(lambda kk: jax.random.uniform(
            jax.random.fold_in(kk, 7), ()))(jnp.asarray(k)))
        jg = np.asarray(jax.vmap(lambda kk: jax.random.uniform(
            kk, (tds.N_CAND,), jnp.float32, 1e-7, 1.0 - 1e-7))(jnp.asarray(k)))
        assert np.array_equal(u_xtc[:, i].numpy(), jx)
        assert np.array_equal(u_g[:, i].numpy(), jg)


SUPPORT_CFGS = [
    {}, {"greedy": True}, {"temp": 0.7, "top_k": 200}, {"top_k": 0, "seed": 3},
    {"dry_multiplier": 0.8}, {"mirostat": 2}, {"adaptive_p_target": 0.5},
    {"adaptive_p_target": -1.0}, {"logit_bias": {i: 1.0 for i in range(16)}},
    {"logit_bias": {i: 1.0 for i in range(17)}}, {"penalty_last_n": -1},
    {"top_n_sigma": 0.0}, {"top_n_sigma": 2.0, "typical_p": 0.5},
]


@pytest.mark.parametrize("cfg", SUPPORT_CFGS, ids=lambda c: repr(c)[:40])
def test_chain_supported_matches_jax(cfg):
    assert tds.chain_supported(cfg) == jds.chain_supported(cfg)


@pytest.mark.parametrize("name", [*CHAIN_CFGS, "supported_mix"])
def test_chain_params_match_jax(name):
    if name == "supported_mix":
        rows = [c for c in SUPPORT_CFGS if jds.chain_supported(c)] + [None]
    else:
        rows = [CHAIN_CFGS[name], None, CHAIN_CFGS["penalties"]]
    jp, tp = jds.chain_params(rows, V), tds.chain_params(rows, V)
    assert list(jp) == list(tp)
    for k in jp:
        assert tp[k].dtype == jp[k].dtype and np.array_equal(tp[k], jp[k]), k
    with pytest.raises(ValueError):
        tds.chain_params([{"mirostat": 1}], V)


def _chain_inputs(name: str, trial: int):
    rng = np.random.default_rng(1000 * sorted(CHAIN_CFGS).index(name) + trial)
    # tie-free rows by construction (distinct levels, permuted, jittered by
    # less than half their spacing): the tie rule is not what these test
    levels = np.linspace(-8.0, 8.0, V)
    logits = np.stack([rng.permutation(levels) for _ in range(B)])
    logits = (logits + rng.uniform(-0.02, 0.02, (B, V))).astype(np.float32)
    assert all(len(np.unique(r)) == V for r in logits)
    ring = rng.integers(0, V, (B, tds.RING)).astype(np.int32)
    ring[:, : 10 + trial] = -1
    keys = rng.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    rows = [CHAIN_CFGS[name]] * (B - 1) + [None]
    return logits, ring, keys, rows


_jax_chain = jax.jit(jds.chain_step)


def _jax_step(logits, ring, keys, rows):
    p = {k: jnp.asarray(v) for k, v in jds.chain_params(rows, V).items()}
    tok, ring2 = _jax_chain(jnp.asarray(logits), jnp.asarray(ring), jnp.asarray(keys), p)
    return np.asarray(tok).astype(np.int64), np.asarray(ring2).astype(np.int64)


@pytest.mark.parametrize("name", list(CHAIN_CFGS))
def test_chain_step_matches_jax(name):
    for trial in range(4):
        logits, ring, keys, rows = _chain_inputs(name, trial)
        jtok, jring = _jax_step(logits, ring, keys, rows)
        # the JAX chain's own uniforms, handed to the port's core
        u_xtc = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            jax.random.fold_in(k, 7), ()))(jnp.asarray(keys)))
        u_g = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (tds.N_CAND,), jnp.float32, 1e-7, 1.0 - 1e-7))(jnp.asarray(keys)))
        sp = tds.chain_tensors(tds.chain_params(rows, V), "cpu")
        lt, rt = torch.from_numpy(logits), _t(ring)
        tok, ring2 = tds.chain_step_core(lt, rt, sp, torch.tensor(u_xtc), torch.tensor(u_g))
        assert np.array_equal(tok.numpy(), jtok), (name, trial)
        assert np.array_equal(ring2.numpy(), jring), (name, trial)
        # and with the uniforms drawn by the port's threefry
        tok2, ring3 = tds.chain_step(lt, rt, _t(keys), sp)
        assert np.array_equal(tok2.numpy(), jtok) and np.array_equal(ring3.numpy(), jring)
        if rows[0].get("greedy"):
            assert np.array_equal(jtok[:-1], logits[:-1].argmax(-1))


def test_chain_stages_change_tokens():
    """Each stage case reaches its stage: against the plain temperature
    config on the same inputs, its tokens differ for some row."""
    base = CHAIN_CFGS["temp"]
    for name in ("top_k_p", "min_p", "typical", "xtc", "dynatemp", "top_n_sigma",
                 "penalties", "bias"):
        differ = False
        for trial in range(4):
            logits, ring, keys, rows = _chain_inputs(name, trial)
            a, _ = _jax_step(logits, ring, keys, rows)
            b, _ = _jax_step(logits, ring, keys, [{**base, "temp": rows[0]["temp"]}] * (B - 1)
                             + [None])
            differ |= not np.array_equal(a, b)
        assert differ, name


SAMPLE_CFGS = [dict(temp=0.0), dict(temp=0.8), dict(temp=0.9, top_k=20),
               dict(temp=1.0, top_p=0.9), dict(temp=0.7, min_p=0.05),
               dict(temp=0.9, top_k=40, top_p=0.95, min_p=0.05)]


@pytest.mark.parametrize("cfg", SAMPLE_CFGS, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_sample_matches_jax(cfg):
    rng = np.random.default_rng(11)
    for seed in (0, 5, 99):
        logits = (rng.standard_normal((3, V)) * 2).astype(np.float32)
        key = _key(seed)
        want = np.asarray(jds.sample(jnp.asarray(logits), jnp.asarray(key), **cfg))
        got = tds.sample(torch.from_numpy(logits), _t(key), **cfg)
        assert np.array_equal(got.numpy(), want.astype(np.int64)), (cfg, seed)
