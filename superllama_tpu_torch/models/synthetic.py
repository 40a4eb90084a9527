"""Synthetic random-weight models: the Llama-3-8B-width model that the
port's chip smoke serves (Q4_K, or one of the ``MIXES`` of other formats,
made on the device in ``repack``'s layout), small shapes for tests, and
seeded random GGUF block bytes of every repackable type (``rand_raw``).
Values are random but layouts, dtypes and byte counts match a repacked
load."""

from __future__ import annotations

import math
import zlib

import torch

from ..device import resolve_device
from ..gguf.constants import KVALUES_IQ4NL, GGMLType
from ..ops.qtensor import QTensor, dequant_qtensor
from .hparams import HParams


def llama3_8b_hparams(**kw) -> HParams:
    """Llama-3-8B dims."""
    d = dict(
        arch="llama", n_vocab=128256, n_ctx_train=8192, n_embd=4096,
        n_layer=32, n_head=32, n_head_kv=8, n_ff=14336, n_rot=128,
        head_dim=128, head_dim_v=128, rms_eps=1e-5, rope_freq_base=500000.0,
    )
    d.update(kw)
    return HParams(**d)


def tiny_test_hparams(**kw) -> HParams:
    d = dict(
        arch="llama", n_vocab=256, n_ctx_train=128, n_embd=64,
        n_layer=2, n_head=4, n_head_kv=2, n_ff=128, n_rot=16,
        head_dim=16, head_dim_v=16,
    )
    d.update(kw)
    return HParams(**d)


def _generator(device: torch.device, seed: int, name: str) -> torch.Generator:
    """A generator per tensor, seeded stably from (seed, name)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed * 0x9E3779B1 + zlib.crc32(name.encode()))
    return g


def rand_q4k(name: str, N: int, K: int, seed: int, device) -> QTensor:
    """Random Q4_K weight in the compact layout, generated on ``device``.

    Codes are uniform nibbles; sub-scales/mins are 6-bit ints in [24, 41) and
    d/dmin are sized so the dequantized weight is zero-mean with std about
    0.6/sqrt(K): sane activations through a deep stack."""
    g = _generator(device, seed, name)
    codes = torch.randint(0, 256, (K // 2, N), generator=g, device=device,
                          dtype=torch.uint8)
    sc = torch.randint(24, 41, (K // 32, N), generator=g, device=device,
                       dtype=torch.uint8)
    s0 = 1.0 / (7.5 * 32.0 * math.sqrt(K))
    d = (torch.rand((K // 256, N), generator=g, device=device) + 0.5) * s0
    # mn == sc and dmin == 7.5·d ⇒ add = −7.5·scale: zero-mean dequant. mn
    # is a copy, not an alias: a kernel reads it from its own addresses, as
    # it does for a loaded weight
    return QTensor(codes, None, None, 32, 0, True, K, N, GGMLType.Q4_K,
                   sc=sc, mn=sc.clone(), d=d, dmin=7.5 * d, sb=8)


def synthetic_qparams_device(hp: HParams, seed: int = 0, device=None) -> dict:
    """Q4_K QTensor matmul weights + bf16 embeddings/norms, all generated
    directly on the device (default CUDA) with explicit generators."""
    dev = resolve_device(device)
    E, H, Hkv, D, Dv, F = (hp.n_embd, hp.n_head, hp.n_head_kv, hp.head_dim,
                           hp.head_dim_v, hp.n_ff)
    qt = lambda name, N, K: rand_q4k(name, N, K, seed, dev)
    emb = torch.randn((hp.n_vocab, E), generator=_generator(dev, seed, "token_embd"),
                      device=dev)
    ones = torch.ones(E, dtype=torch.bfloat16, device=dev)
    params = {
        "token_embd": (emb * 0.02).to(torch.bfloat16),
        "output_norm": ones,
        "output": qt("output", hp.n_vocab, E),
        "layers": [],
    }
    del emb
    for il in range(hp.n_layer):
        params["layers"].append({
            "attn_norm": ones,
            "wq": qt(f"l{il}.wq", H * D, E),
            "wk": qt(f"l{il}.wk", Hkv * D, E),
            "wv": qt(f"l{il}.wv", Hkv * Dv, E),
            "wo": qt(f"l{il}.wo", E, H * Dv),
            "ffn_norm": ones,
            "ffn_gate": qt(f"l{il}.ffn_gate", F, E),
            "ffn_up": qt(f"l{il}.ffn_up", F, E),
            "ffn_down": qt(f"l{il}.ffn_down", E, F),
        })
    return params


def rand_planes(ttype: GGMLType, name: str, N: int, K: int, seed: int, device) -> QTensor:
    """A random (K, N) weight of ``ttype`` in the layout ``repack`` gives it
    (the same planes, dtypes, shapes and fields), generated on ``device``:
    a full-width model's worth in a second, where numpy's repack of
    ``rand_raw`` bytes takes 16-52 s a model on the H100 machine's host
    (PERF.md section 4). Q4_K as ``rand_q4k``; Q4_0 (nibbles, f16-valued
    scales, offset 8), Q5_K (Q4_K's planes and a random 1-bit hi plane),
    Q6_K (nibbles, a 2-bit hi plane, signed sub-scales) and IQ4_XS (IQ4_NL
    codebook values, scales d·(ls − 32) of 6-bit ls). Every weight has a
    std of about 0.6/sqrt(K)."""
    if ttype == GGMLType.Q4_K:
        return rand_q4k(name, N, K, seed, device)
    g = _generator(device, seed, name)
    ri = lambda lo, hi, shape, dt=torch.uint8: torch.randint(
        lo, hi, shape, generator=g, device=device, dtype=dt)
    f16 = lambda t: t.to(torch.float16).to(torch.float32)   # an f16 wire field
    u = lambda shape: torch.rand(shape, generator=g, device=device) + 0.5
    rk = math.sqrt(K)
    if ttype == GGMLType.Q4_0:      # codes - 8 in [-8, 8): std 4.61
        return QTensor(ri(0, 256, (K // 2, N)), f16(u((K // 32, N)) * (0.6 / (4.61 * rk))),
                       None, 32, 8, True, K, N, ttype)
    if ttype == GGMLType.Q5_K:      # codes in [0, 32), mn == sc, dmin = 15.5 d
        sc = ri(24, 41, (K // 32, N))
        d = f16(u((K // 256, N)) / (15.5 * 32.0 * rk))
        return QTensor(ri(0, 256, (K // 2, N)), None, None, 32, 0, True, K, N, ttype,
                       sc=sc, mn=sc.clone(), d=d, dmin=f16(15.5 * d),
                       hi=ri(0, 256, (K // 8, N)), hi_bits=1, sb=8)
    if ttype == GGMLType.Q6_K:      # codes - 32 in [-32, 32), sc in [-32, 33)
        d = f16(u((K // 256, N)) / (18.5 * 18.8 * rk / 0.6))
        return QTensor(ri(0, 256, (K // 2, N)), None, None, 16, 32, True, K, N, ttype,
                       sc=ri(-32, 33, (K // 16, N), torch.int8), d=d,
                       hi=ri(0, 256, (K // 4, N)), hi_bits=2, sb=16)
    if ttype == GGMLType.IQ4_XS:    # codebook values (rms 67.4) x (ls - 32) (rms 18.5)
        lut = torch.tensor(KVALUES_IQ4NL, dtype=torch.int8, device=device)
        codes = lut[ri(0, 16, (K, N), torch.int64)]
        d = f16(u((K // 256, N)) * (0.6 / (67.4 * 18.5 * rk)))
        ls = ri(0, 64, (K // 32, N)).to(torch.float32) - 32.0
        return QTensor(codes, d.repeat_interleave(8, dim=0) * ls, None, 32, 0, False,
                       K, N, ttype)
    raise NotImplementedError(f"no on-device generator for {ttype.name}")


# model mixes, named after llama.cpp's file types: (type of a block weight
# by role, the output head's type, token_embd's type or None for bf16)
MIXES = {
    "Q4_0": (lambda role: GGMLType.Q4_0, GGMLType.Q6_K, GGMLType.Q4_0),
    "Q5_K_M": (lambda role: GGMLType.Q6_K if role in ("wv", "ffn_down") else GGMLType.Q5_K,
               GGMLType.Q6_K, None),
    "IQ4_XS": (lambda role: GGMLType.IQ4_XS, GGMLType.Q6_K, None),
}


def synthetic_qparams_mix(hp: HParams, mix: str, seed: int = 0, device=None) -> dict:
    """The matmul weights of a ``MIXES`` entry in repack's layout
    (``rand_planes``) + bf16 embeddings/norms, all generated directly on the
    device (default CUDA). A quantized ``token_embd`` is a table of the
    mix's type dequantized to bf16, as the loader dequantizes it."""
    dev = resolve_device(device)
    E, H, Hkv, D, Dv, F, V = (hp.n_embd, hp.n_head, hp.n_head_kv, hp.head_dim,
                              hp.head_dim_v, hp.n_ff, hp.n_vocab)
    block_type, head_type, embd_type = MIXES[mix]
    qt = lambda name, role, N, K: rand_planes(block_type(role), name, N, K, seed, dev)
    if embd_type is not None:
        emb = dequant_qtensor(rand_planes(embd_type, "token_embd", V, E, seed, dev),
                              torch.bfloat16).t().contiguous()
    else:
        emb = (torch.randn((V, E), generator=_generator(dev, seed, "token_embd"),
                           device=dev) * 0.02).to(torch.bfloat16)
    ones = torch.ones(E, dtype=torch.bfloat16, device=dev)
    params = {"token_embd": emb, "output_norm": ones,
              "output": rand_planes(head_type, "output", V, E, seed, dev), "layers": []}
    for il in range(hp.n_layer):
        params["layers"].append({
            "attn_norm": ones,
            "wq": qt(f"l{il}.wq", "wq", H * D, E),
            "wk": qt(f"l{il}.wk", "wk", Hkv * D, E),
            "wv": qt(f"l{il}.wv", "wv", Hkv * Dv, E),
            "wo": qt(f"l{il}.wo", "wo", E, H * Dv),
            "ffn_norm": ones,
            "ffn_gate": qt(f"l{il}.ffn_gate", "ffn_gate", F, E),
            "ffn_up": qt(f"l{il}.ffn_up", "ffn_up", F, E),
            "ffn_down": qt(f"l{il}.ffn_down", "ffn_down", E, F),
        })
    return params


# --- random GGUF block bytes of any repackable type ---------------------------

# (block elements, block bytes, [(offset, kind, ratio)] of the block's scale
# fields: "f16" / "f32" a d of ratio times the block's d (a min of Q4_1 /
# Q5_1, added, and a dmin of the K-quants, subtracted, sized to zero-center
# the weights), "e8m0" MXFP4's exponent byte, "iq1m" IQ1_M's d spread over
# its sc fields)
_D = [(0, "f16", 1.0)]
_SCALE_FIELDS = {
    GGMLType.Q4_0: (32, 18, _D),
    GGMLType.Q4_1: (32, 20, _D + [(2, "f16", -7.5)]),
    GGMLType.Q5_0: (32, 22, _D),
    GGMLType.Q5_1: (32, 24, _D + [(2, "f16", -15.5)]),
    GGMLType.Q8_0: (32, 34, _D),
    GGMLType.MXFP4: (32, 17, [(0, "e8m0", 1.0)]),
    GGMLType.IQ4_NL: (32, 18, _D),
    GGMLType.Q2_K: (256, 84, [(80, "f16", 1.0), (82, "f16", 1.5)]),
    GGMLType.Q3_K: (256, 110, [(108, "f16", 1.0)]),
    GGMLType.Q4_K: (256, 144, _D + [(2, "f16", 7.5)]),
    GGMLType.Q5_K: (256, 176, _D + [(2, "f16", 15.5)]),
    GGMLType.Q6_K: (256, 210, [(208, "f16", 1.0)]),
    GGMLType.Q8_K: (256, 292, [(0, "f32", 1.0)]),
    GGMLType.IQ2_XXS: (256, 66, _D),
    GGMLType.IQ2_XS: (256, 74, _D),
    GGMLType.IQ2_S: (256, 82, _D),
    GGMLType.IQ3_XXS: (256, 98, _D),
    GGMLType.IQ3_S: (256, 110, _D),
    GGMLType.IQ1_S: (256, 50, _D),
    GGMLType.IQ1_M: (256, 56, [(48, "iq1m", 1.0)]),
    GGMLType.IQ4_XS: (256, 136, _D),
    GGMLType.TQ1_0: (256, 54, [(52, "f16", 1.0)]),
    GGMLType.TQ2_0: (256, 66, [(64, "f16", 1.0)]),
}


def _set_scales(blocks, fields, d) -> None:
    """Write the per-block scale ``d`` (f32 (nb,)) into each scale field."""
    import numpy as np

    for off, kind, ratio in fields:
        v = d * np.float32(ratio)
        if kind == "f32":
            blocks[:, off:off + 4] = v.astype("<f4").view(np.uint8).reshape(-1, 4)
        elif kind == "e8m0":      # 2^(e-128), e rounded from log2 d
            blocks[:, off] = np.clip(np.rint(np.log2(v)) + 128, 1, 254).astype(np.uint8)
        elif kind == "iq1m":      # d's f16 bits in the top nibble of 4 u16 fields
            bits = v.astype("<f2").view(np.uint16)
            sc = blocks[:, off:off + 8].copy().view("<u2")
            for i in range(4):
                sc[:, i] = (sc[:, i] & 0x0FFF) | (((bits >> (4 * i)) & 0xF) << 12)
            blocks[:, off:off + 8] = sc.view(np.uint8)
        else:
            blocks[:, off:off + 2] = v.astype("<f2").view(np.uint8).reshape(-1, 2)


def rand_raw(ttype: GGMLType, N: int, K: int, seed: int):
    """Seeded random GGUF block bytes of a (N, K) weight of any repackable
    type (a 1-D uint8 array, as a file holds it). Codes, sub-scales and grid
    indices are uniform random bytes; each block's d (and min) fields are
    overwritten with finite values, so that every block is valid and the
    dequantized weight has a std of about 0.6/sqrt(K) (the mins about
    zero-center it): sane activations through a deep stack."""
    import numpy as np

    from ..gguf.quants import DEQUANTIZERS

    bs, ts, fields = _SCALE_FIELDS[ttype]
    nb = N * K // bs
    rng = np.random.default_rng([seed, int(ttype), N, K])
    blocks = rng.integers(0, 256, (nb, ts), dtype=np.uint8)
    # the dequantized std at d = 1 over a sample of blocks sets the d
    sample = blocks[:256].copy()
    _set_scales(sample, fields, np.ones(len(sample), np.float32))
    std = float(np.std(DEQUANTIZERS[ttype](sample.reshape(-1))))
    u = rng.uniform(0.5, 1.5, nb).astype(np.float32)
    _set_scales(blocks, fields, u * np.float32(0.6 / math.sqrt(K) / std))
    return blocks.reshape(-1)
