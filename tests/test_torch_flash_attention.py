"""Port parity: flash attention (superllama_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel in interpret mode, on the
``FA_CELLS`` grid of tests/test_backend_ops.py and the same numpy-seeded
inputs. Only rows with q_pos >= 0 are compared.

Tolerances: NMSE < 1e-9 in f32 (same logits, summation order differs);
< 2e-5 with Q8_0 K/V, where both sides round the dequantized V and the
probabilities to bf16 and a rounding boundary can fall either way.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.ops.flash_attention import flash_attention as jax_fa
from superllama_tpu_torch.ops.flash_attention import flash_attention
from test_torch_fixtures import cuda_typed, failing_build

FA_CELLS = []
for T, S in ((1, 256), (8, 256), (64, 64), (100, 131)):
    for G in (1, 4):
        FA_CELLS.append((T, S, G, 0, 0.0, False, False))
for T, S in ((1, 256), (64, 128)):
    FA_CELLS += [
        (T, S, 4, 32, 0.0, False, False),   # sliding window
        (T, S, 4, 0, 30.0, False, False),   # softcap
        (T, S, 4, 0, 0.0, True, False),     # sinks
        (T, S, 4, 0, 0.0, False, True),     # Q8_0 KV
        (T, S, 4, 32, 0.0, True, True),     # combined
    ]


def _inputs(T, S, G, sinks, q8, pad_rows=0, B=2, Hkv=2, D=64):
    H = Hkv * G
    rng = np.random.default_rng(T * 1000 + S + G)
    q = rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    n_past = max(S - T - 3, 0)              # a few empty slots at the tail
    q_pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None] + n_past,
                            (B, T)).copy()
    if pad_rows:
        q_pos[:, T - pad_rows:] = -1
    kv_pos = np.where(np.arange(S)[None] < n_past + T, np.arange(S)[None], -1)
    kv_pos = np.broadcast_to(kv_pos.astype(np.int32), (B, S)).copy()
    out = {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_pos": kv_pos,
           "sinks": rng.normal(0, 1, (H,)).astype(np.float32) if sinks else None}
    if q8:
        ks = np.abs(k).max(-1) / np.float32(127.0)
        vs = np.abs(v).max(-1) / np.float32(127.0)
        out["k"] = np.round(k / ks[..., None]).astype(np.int8)
        out["v"] = np.round(v / vs[..., None]).astype(np.int8)
        out["k_scale"], out["v_scale"] = ks, vs
    return out


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_both(inp, swa=0, softcap=0.0):
    tj = {k: (None if v is None else jnp.asarray(v)) for k, v in inp.items()}
    tt = {k: (None if v is None else _torch(v)) for k, v in inp.items()}
    ref = jax_fa(tj.pop("q"), tj.pop("k"), tj.pop("v"), tj.pop("q_pos"),
                 tj.pop("kv_pos"), swa_window=swa, logit_softcap=softcap,
                 interpret=True, **tj)
    got = flash_attention(tt.pop("q"), tt.pop("k"), tt.pop("v"), tt.pop("q_pos"),
                          tt.pop("kv_pos"), swa_window=swa,
                          logit_softcap=softcap, **tt)
    return np.asarray(got.to(torch.float32)), np.asarray(ref, np.float32)


def _nmse(got, ref) -> float:
    return float(np.mean((got.astype(np.float64) - ref) ** 2) / np.mean(ref.astype(np.float64) ** 2))


@pytest.mark.parametrize("T,S,G,swa,softcap,sinks,q8", FA_CELLS,
                         ids=lambda *_: None)
def test_flash_attention_matches_jax(T, S, G, swa, softcap, sinks, q8):
    got, ref = _run_both(_inputs(T, S, G, sinks, q8), swa, softcap)
    assert got.shape == ref.shape
    assert _nmse(got, ref) < (2e-5 if q8 else 1e-9)


def test_padded_rows_finite_and_valid_rows_match():
    inp = _inputs(40, 96, 4, True, False, pad_rows=7)
    got, ref = _run_both(inp, swa=16)
    assert np.isfinite(got).all()
    valid = inp["q_pos"] >= 0
    assert _nmse(got[valid], ref[valid]) < 1e-9


def test_bf16_query_matches_jax():
    inp = _inputs(32, 64, 4, False, False)
    for name in ("q", "k", "v"):
        inp[name] = inp[name].astype(jnp.bfloat16)
    got, ref = _run_both(inp)
    # bf16 outputs on both sides: one bf16 rounding of nearly equal values
    assert _nmse(got, ref) < 1e-5


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel: when the build fails, the wrapper
    raises that failure and never runs the plain version."""
    build_failed = failing_build(monkeypatch)
    inp = _inputs(32, 64, 4, True, True)
    args = {k: cuda_typed(torch.from_numpy(v)) for k, v in inp.items()}
    before = flash_attention.launches
    with pytest.raises(build_failed):
        flash_attention(args.pop("q"), args.pop("k"), args.pop("v"),
                        args.pop("q_pos"), args.pop("kv_pos"), **args)
    assert flash_attention.launches == before


@pytest.mark.parametrize("D", [80, 100])
@pytest.mark.parametrize("q8", [False, True])
def test_head_sizes_match_jax(D, q8):
    """Head sizes the CUDA kernel pads (80, 100): the port's version against
    the JAX kernel, as in the grid above."""
    got, ref = _run_both(_inputs(40, 96, 4, True, q8, D=D), swa=24)
    assert got.shape == ref.shape
    assert _nmse(got, ref) < (2e-5 if q8 else 1e-9)
