"""Port parity: split-KV flash decode (superllama_tpu_torch.ops
.flash_attention.flash_decode_attention) against the JAX package's Pallas
kernel in interpret mode, on the ``FD_CELLS`` grid of
tests/test_backend_ops.py with the same numpy-seeded inputs.

The JAX side is compiled with XLA's excess precision off (``xla_exact``), so
its bf16 roundings happen as written. Tolerances, as NMSE with f32 queries:
 - f and q8: < 1e-9. Both sides compute the same logits; the sums run in
   another order, the chunks' softmax states are combined at the end rather
   than carried across chunks, and exp differs by an ulp between XLA and
   torch, which can move one int8 p code by one step (about 1e-8 relative
   in one term). The grid measures 1e-13 or less.
 - q4: < 1e-7. At S 2048 the JAX side's bf16 P.V dot on the CPU departs
   from the exact sum of its own bf16 terms by NMSE 3e-8, while the port
   agrees with an f64 evaluation of the same roundings to 3e-14; the other
   q4 cells agree to 1e-13.
Across several chunks, q4 rounds each probability to bf16 relative to its
chunk's own max where JAX uses the running max: a relative 2^-9 difference
per probability, held to the bf16 limit 1e-5. bf16 queries: < 1e-5, one
bf16 rounding of nearly equal outputs per side.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.ops.flash_attention import flash_decode_attention as jax_fd
from superllama_tpu.runtime import kv_cache as JK
from superllama_tpu_torch.ops.flash_attention import flash_decode_attention
from superllama_tpu_torch.runtime import kv_cache as TK
from test_torch_fixtures import cuda_typed, failing_build, xla_exact

# (T, S, G, kv, swa, softcap, sinks): the FD_CELLS of tests/test_backend_ops.py
FD_CELLS = [(1, S, G, kv, 0, 0.0, False) for S in (256, 1000, 2048) for G in (1, 4)
            for kv in ("f", "q8", "q4")]
FD_CELLS += [
    (1, 512, 4, "f", 64, 0.0, False),    # sliding window
    (1, 512, 4, "q8", 0, 30.0, False),   # softcap on quantized KV
    (1, 512, 4, "f", 0, 0.0, True),      # attention sinks
    (8, 512, 4, "q8", 0, 0.0, False),    # T=8 multi-token decode
    (2, 512, 2, "q4", 64, 0.0, True),    # combined q4+swa+sinks
]


def _inputs(T, S, G, kv, sinks, B=2, Hkv=2, D=64, pad_rows=0, seed=None):
    """Numpy inputs in the layout of tests/test_backend_ops.py; the K/V
    codes and scales come from the JAX package's quantizers."""
    H = Hkv * G
    rng = np.random.default_rng(S + 17 * G if seed is None else seed)
    q = rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    n_past = S - T - 3
    q_pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None] + n_past, (B, T)).copy()
    if pad_rows:
        q_pos[:, T - pad_rows:] = -1
    kv_pos = np.where(np.arange(S)[None] < n_past + T, np.arange(S)[None], -1)
    out = {"q": q, "k": k, "v": v, "q_pos": q_pos,
           "kv_pos": np.broadcast_to(kv_pos.astype(np.int32), (B, S)).copy(),
           "sinks": rng.normal(0, 1, (H,)).astype(np.float32) if sinks else None}
    if kv != "f":
        quantize = JK.q8_quantize_rows if kv == "q8" else JK.q4_quantize_rows
        for name in ("k", "v"):
            codes, scales = quantize(jnp.asarray(out[name]))
            out[name], out[name[0] + "_scale"] = np.asarray(codes), np.asarray(scales)
    return out


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_both(inp, swa=0, softcap=0.0, block_s=None, jax_block_s=None):
    names = ("q", "k", "v", "q_pos", "kv_pos", "sinks", "k_scale", "v_scale")
    vals = [inp.get(n) for n in names]
    fn = functools.partial(jax_fd, swa_window=swa, logit_softcap=softcap,
                           interpret=True, block_s=jax_block_s or block_s)
    ref = xla_exact(lambda *a: fn(*a[:5], **dict(zip(names[5:], a[5:]))),
                    *[None if x is None else jnp.asarray(x) for x in vals])
    tt = [None if x is None else _torch(x) for x in vals]
    got = flash_decode_attention(*tt[:5], swa_window=swa, logit_softcap=softcap,
                                 block_s=block_s, **dict(zip(names[5:], tt[5:])))
    return np.asarray(got.to(torch.float32)), np.asarray(ref, np.float32)


TOL = {"f": 1e-9, "q8": 1e-9, "q4": 1e-7}
SPLIT_TOL = {"f": 1e-9, "q8": 1e-9, "q4": 1e-5}


def _nmse(got, ref) -> float:
    return float(np.mean((got.astype(np.float64) - ref) ** 2)
                 / np.mean(ref.astype(np.float64) ** 2))


@pytest.mark.parametrize("T,S,G,kv,swa,softcap,sinks", FD_CELLS, ids=lambda *_: None)
def test_flash_decode_matches_jax(T, S, G, kv, swa, softcap, sinks):
    got, ref = _run_both(_inputs(T, S, G, kv, sinks), swa, softcap)
    assert got.shape == ref.shape
    assert _nmse(got, ref) < TOL[kv]


@pytest.mark.parametrize("kv", ["f", "q8", "q4"])
def test_split_chunks_match_jax(kv):
    """block_s 256 over S 1000: four chunks, the last one 232 slots long
    (the TPU kernel's s_rem); JAX carries the state across chunks, the port
    combines the chunks at the end."""
    got, ref = _run_both(_inputs(1, 1000, 4, kv, True, seed=5), block_s=256)
    assert _nmse(got, ref) < SPLIT_TOL[kv]


@pytest.mark.parametrize("kv", ["f", "q4"])
def test_split_kv_combine(kv):
    """The test_backend_ops.py split case: one 1024-slot chunk against four
    of 256 give the same attention (q4 rounds p to bf16 relative to another
    max). q8 is left out: its p quantization follows the chunks by design."""
    inp = _inputs(1, 1024, 4, kv, False, B=1, seed=9)
    inp["q_pos"][:] = 1023
    inp["kv_pos"][:] = np.arange(1024, dtype=np.int32)
    tt = {k: None if v is None else _torch(v) for k, v in inp.items()}
    args = [tt.pop(n) for n in ("q", "k", "v", "q_pos", "kv_pos")]
    one = flash_decode_attention(*args, block_s=1024, **tt)
    four = flash_decode_attention(*args, block_s=256, **tt)
    if kv == "f":
        np.testing.assert_allclose(four.numpy(), one.numpy(), atol=1e-5, rtol=1e-5)
    else:
        assert _nmse(four.numpy(), one.numpy()) < SPLIT_TOL[kv]


@pytest.mark.parametrize("kv", ["f", "q8", "q4"])
def test_bf16_query_matches_jax(kv):
    inp = _inputs(8, 512, 4, kv, False, seed=3)
    inp["q"] = inp["q"].astype(jnp.bfloat16)
    if kv == "f":
        inp["k"], inp["v"] = inp["k"].astype(jnp.bfloat16), inp["v"].astype(jnp.bfloat16)
    got, ref = _run_both(inp)
    assert _nmse(got, ref) < 1e-5


def test_padded_rows_finite_and_valid_rows_match():
    inp = _inputs(8, 300, 4, "q8", True, pad_rows=3, seed=4)
    got, ref = _run_both(inp, swa=40)
    assert np.isfinite(got).all()
    valid = inp["q_pos"] >= 0
    assert _nmse(got[valid], ref[valid]) < 1e-9


def test_quantized_cache_layer_feeds_the_kernel():
    """The port's cache views (spare slot, strided) go in as they are and
    give the result of contiguous copies."""
    B, Hkv, G, D, S = 2, 2, 4, 64, 96
    rng = np.random.default_rng(6)
    cache = TK.kv_cache_init(1, B, S, Hkv, D, dtype="q4_0")
    k = torch.from_numpy(rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32))
    slots = TK.kv_write_slots(cache, S)
    TK.kv_advance(cache, slots, torch.arange(S, dtype=torch.int32)[None].expand(B, S))
    TK.kv_update_layer(cache, 0, slots, k, v)
    q = torch.from_numpy(rng.normal(0, 1, (B, 1, Hkv * G, D)).astype(np.float32))
    q_pos = torch.full((B, 1), S - 1, dtype=torch.int32)
    ck, cv, ks, vs = cache.layer(0, 64)
    got = flash_decode_attention(q, ck, cv, q_pos, cache.positions(64), k_scale=ks,
                                 v_scale=vs)
    ref = flash_decode_attention(q, ck.contiguous(), cv.contiguous(), q_pos,
                                 cache.positions(64).contiguous(),
                                 k_scale=ks.contiguous(), v_scale=vs.contiguous())
    assert torch.equal(got, ref)


@pytest.mark.parametrize("kv", ["f", "q8", "q4"])
def test_cuda_tensor_never_takes_plain_path(monkeypatch, kv):
    """A CUDA tensor goes to the kernel: when the build fails, the wrapper
    raises that failure and never runs the plain version."""
    build_failed = failing_build(monkeypatch)
    inp = _inputs(1, 256, 4, kv, True)
    args = {k: cuda_typed(torch.from_numpy(v)) for k, v in inp.items() if v is not None}
    before = flash_decode_attention.launches
    with pytest.raises(build_failed):
        flash_decode_attention(args.pop("q"), args.pop("k"), args.pop("v"),
                               args.pop("q_pos"), args.pop("kv_pos"), **args)
    assert flash_decode_attention.launches == before


@pytest.mark.parametrize("D,kv", [(80, "f"), (100, "f"), (80, "q8"), (100, "q8"),
                                  (96, "q4")])
def test_head_sizes_match_jax(D, kv):
    """Head sizes whose cache rows are not 16-byte multiples (Q8_0 at D 100:
    100-byte rows) or not powers of two, against the JAX kernel."""
    got, ref = _run_both(_inputs(2, 300, 4, kv, True, D=D, seed=D), block_s=128)
    assert got.shape == ref.shape
    assert _nmse(got, ref) < SPLIT_TOL[kv]


def test_long_chunk_matches_jax():
    """T*G 32 over one 1024-slot chunk (two passes of the decode kernel on the
    card) against the JAX kernel at the same block_s."""
    got, ref = _run_both(_inputs(8, 1024, 4, "q8", False, seed=11), block_s=1024)
    assert _nmse(got, ref) < TOL["q8"]
