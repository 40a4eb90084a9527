"""Decode-attention routing probe: time, at decode shapes, the plain route
the model takes on a float cache (``ops/ref.attention_gqa`` with
``causal_mask``), the prefill kernel ``flash_attention`` (``fa``), the
split-KV kernel ``flash_decode_attention`` (``fd``) and ``fd`` on a Q8_0
cache, to settle which should serve decode.

Counterpart of the JAX package's ``tools/flash_decode_probe.py``. Each
implementation is timed as a chain of data-dependent links
(q ← q + salt·attention(q)) between CUDA events, with a fixed number of
links after a short warm-up.

Prints one JSON line per cell, e.g.
  {"cell": "B8_T1_S8192", "plain_ms": .., "fdec_ms": .., ...}
and a final recommendation line.

Run: python -m superllama_tpu_torch.tools.flash_decode_probe [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..device import resolve_device
from ..ops.flash_attention import flash_attention, flash_decode_attention
from ..ops.ref import attention_gqa
from ..runtime.kv_cache import causal_mask, q8_quantize_rows
from .ops_bench import chain_seconds, device_name


def _rate_ms(link, q0, reps: int) -> float:
    """ms per link; the salt cycles through values representable in bf16,
    so every link changes q."""
    return chain_seconds(lambda q, i: link(q, 0.25 + 0.125 * (i % 4)), q0, reps) * 1e3


def probe(Bs=(1, 8), Ts=(1,), Ss=(2048, 8192, 32768), H=32, Hkv=8, D=128,
          dtype=torch.bfloat16, q8=True, reps=20, device=None) -> list[dict]:
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(D)
    results = []
    for B in Bs:
        for T in Ts:
            for S in Ss:
                g = torch.Generator(device=dev)
                g.manual_seed(0)
                q0 = torch.randn((B, T, H, D), generator=g, device=dev).to(dtype)
                k = torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dtype)
                v = torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dtype)
                kv_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
                q_pos = torch.arange(S - T, S, dtype=torch.int32, device=dev).repeat(B, 1)

                def plain(q, salt):
                    o = attention_gqa(q, k, v, causal_mask(kv_pos, q_pos), scale=scale)
                    return q + o.to(q.dtype) * salt

                def flash(q, salt):
                    o = flash_attention(q, k, v, q_pos, kv_pos, scale=scale)
                    return q + o.to(q.dtype) * salt

                def fdec(q, salt):
                    o = flash_decode_attention(q, k, v, q_pos, kv_pos, scale=scale)
                    return q + o.to(q.dtype) * salt

                impls = [("plain", plain), ("flash", flash), ("fdec", fdec)]
                if q8:
                    # int8 codes + f32 per-row scale, like the Q8_0 KV cache
                    (kq, ks), (vq, vs) = q8_quantize_rows(k), q8_quantize_rows(v)

                    def fdq8(q, salt):
                        o = flash_decode_attention(q, kq, vq, q_pos, kv_pos, scale=scale,
                                                   k_scale=ks, v_scale=vs)
                        return q + o.to(q.dtype) * salt

                    impls.append(("fdq8", fdq8))
                row = {"cell": f"B{B}_T{T}_S{S}"}
                for name, link in impls:
                    row[f"{name}_ms"] = _rate_ms(link, q0, reps)
                row["fdec_vs_plain"] = row["fdec_ms"] / row["plain_ms"]
                row["device"] = device_name(dev)
                results.append(row)
                print(json.dumps(row), flush=True)

    wins = sum(r["fdec_vs_plain"] < 1.0 for r in results)
    rec = ("route float-cache decode to flash_decode_attention"
           if results and wins > len(results) / 2
           else "keep the plain attention route for decode shapes")
    print(json.dumps({"recommendation": rec,
                      "cells_fdec_faster": f"{wins}/{len(results)}"}), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-smoke shapes: B 1/2, S 64/128, 4/2 heads, D 32, one link")
    args = ap.parse_args(argv)
    if args.tiny:
        probe(Bs=(1, 2), Ss=(64, 128), H=4, Hkv=2, D=32, reps=1, device=args.device)
    else:
        probe(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
