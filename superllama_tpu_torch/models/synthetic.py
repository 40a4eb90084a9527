"""Synthetic random-weight models: the Llama-3-8B-width Q4_K model that the
port's chip smoke serves, and small shapes for tests. Values are random but
layouts, dtypes and byte counts match a repacked Q4_K load."""

from __future__ import annotations

import math
import zlib

import torch

from ..device import resolve_device
from ..gguf.constants import GGMLType
from ..ops.qtensor import QTensor
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
