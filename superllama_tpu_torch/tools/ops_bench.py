"""Per-kernel performance of the port: achieved GB/s of the bandwidth-bound
kernels (quantized GEMV decode, split-KV decode attention, paged attention)
and TFLOP/s of the compute-bound ones (quantized matmul prefill, flash
attention prefill).

Counterpart of the JAX package's ``tools/ops_bench.py``, at its shapes. Each
measurement times a data-dependent chain (every link consumes the previous
link's output) between CUDA events after a warm-up, so a link's time
includes its few feedback ops. The bandwidth benches rotate over R distinct
weights or caches that together exceed the card's 50 MB L2, so every call
streams from device memory, as a decode step does.

Run: python -m superllama_tpu_torch.tools.ops_bench [--small | --tiny]
     [--device cpu] [--out PATH]   (default out: chiprun_out/ops_perf.json)
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..models.synthetic import rand_q4k
from ..ops.qtensor import QTensor

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "ops_perf.json"


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def chain_seconds(step, x0, n: int, warmup: int = 2) -> float:
    """Seconds per link of the chain x ← step(x, i): CUDA events around n
    links after ``warmup`` links on a GPU, the host clock on the CPU."""
    x = x0
    for i in range(warmup):
        x = step(x, i)
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(n):
            x = step(x, i)
        return (time.perf_counter() - t0) / n
    torch.cuda.synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        x = step(x, i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def q4k_device(N: int, K: int, seed: int = 0, device=None) -> QTensor:
    """Random Q4_K weight (the compact layout of a repacked load) generated
    on the device."""
    return rand_q4k(f"ops_bench.{seed}", N, K, seed, resolve_device(device))


def _randn(shape, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _fold(y: torch.Tensor, K: int) -> torch.Tensor:
    """y (..., N) → the next link's x (..., K): tiled to K, squashed."""
    x = y.repeat(*([1] * (y.ndim - 1)), -(-K // y.shape[-1]))[..., :K]
    return x / (1.0 + torch.abs(x))


def bench_qmv(N=4096, K=4096, R=16, reps=40, device=None) -> dict:
    """Quantized GEMV decode (the int8-activation ``qmv`` kernel) at M 1:
    GB/s of weight traffic."""
    from ..ops.qmatmul import qmatmul

    dev = resolve_device(device)
    qts = [q4k_device(N, K, seed=i, device=dev) for i in range(R)]

    def step(x, _):
        for qt in qts:
            x = _fold(qmatmul(x, qt, act_quant=True), K)
        return x

    dt = chain_seconds(step, torch.ones((1, K), device=dev), reps) / R
    return {"GBps": qts[0].nbytes / dt / 1e9, "us_per_call": dt * 1e6,
            "shape": f"Q4_K {N}x{K} M=1", "device": device_name(dev)}


def bench_qmm(M=1024, N=4096, K=4096, reps=20, device=None) -> dict:
    """Quantized matmul prefill: TFLOP/s. ``qmatmul`` takes the fused
    ``qmm`` kernel up to M 32 and dequantize + dense GEMM above, as in the
    JAX package."""
    from ..ops.qmatmul import qmatmul

    dev = resolve_device(device)
    qt = q4k_device(N, K, seed=1, device=dev)
    dt = chain_seconds(lambda x, _: _fold(qmatmul(x, qt), K),
                       torch.ones((M, K), device=dev), reps)
    return {"TFLOPs": 2 * M * N * K / dt / 1e12, "us_per_call": dt * 1e6,
            "shape": f"Q4_K {M}x{K}x{N}", "device": device_name(dev)}


def bench_fa_prefill(T=2048, S=2048, Hkv=8, G=4, D=128, reps=10, device=None) -> dict:
    """Flash-attention prefill (the ``fa`` kernel): TFLOP/s at 4·H·T·S·D."""
    from ..ops.flash_attention import flash_attention

    dev = resolve_device(device)
    H = Hkv * G
    k = _randn((1, Hkv, S, D), 0, dev, torch.bfloat16)
    v = _randn((1, Hkv, S, D), 1, dev, torch.bfloat16)
    q_pos = (torch.arange(T, dtype=torch.int32, device=dev) + (S - T))[None]
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev)[None]

    def step(q, _):
        o = flash_attention(q.to(torch.bfloat16), k, v, q_pos, kv_pos)
        return (o / (1.0 + torch.abs(o))).to(torch.float32)

    dt = chain_seconds(step, torch.ones((1, T, H, D), device=dev), reps)
    return {"TFLOPs": 4 * H * T * S * D / dt / 1e12, "us_per_call": dt * 1e6,
            "shape": f"T{T} S{S} H{H} D{D} bf16", "device": device_name(dev)}


def _target_sets(per_set: float) -> int:
    """Distinct K/V sets that together hold about 420 MB, 2 to 32."""
    return max(2, min(32, math.ceil(420e6 / per_set)))


def bench_fa_decode(S=8192, Hkv=8, G=4, D=128, kv="q8", reps=8, device=None) -> dict:
    """Split-KV decode attention (the ``fd`` kernel) at T 1 over a deep
    cache: GB/s of K/V traffic. kv ∈ {bf16, q8, q4}."""
    from ..ops.flash_attention import flash_decode_attention
    from ..runtime.kv_cache import q4_quantize_rows, q8_quantize_rows

    dev = resolve_device(device)
    H = Hkv * G
    R = _target_sets(Hkv * S * D * 2 * {"bf16": 2, "q8": 1, "q4": 0.5}[kv])
    sets = []
    for i in range(R):
        kf = _randn((1, Hkv, S, D), 2 * i, dev)
        vf = _randn((1, Hkv, S, D), 2 * i + 1, dev)
        if kv == "bf16":
            sets.append((kf.to(torch.bfloat16), vf.to(torch.bfloat16)))
        else:
            quantize = q8_quantize_rows if kv == "q8" else q4_quantize_rows
            (k, ks), (v, vs) = quantize(kf), quantize(vf)
            sets.append((k, v, ks, vs))
    kv_bytes = sum(t.numel() * t.element_size() for t in sets[0])
    q_pos = torch.full((1, 1), S - 1, dtype=torch.int32, device=dev)
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev)[None]

    def step(q, _):
        for k, v, *scales in sets:
            kw = dict(zip(("k_scale", "v_scale"), scales))
            o = flash_decode_attention(q, k, v, q_pos, kv_pos, **kw).to(torch.float32)
            q = o / (1.0 + torch.abs(o))
        return q

    dt = chain_seconds(step, torch.ones((1, 1, H, D), device=dev), reps) / R
    return {"GBps": kv_bytes / dt / 1e9, "us_per_call": dt * 1e6,
            "shape": f"T1 S{S} H{H} D{D} {kv} KV", "device": device_name(dev)}


def bench_paged_attention(S=8192, P=256, Hkv=8, G=4, D=128, B=1, reps=8,
                          device=None) -> dict:
    """Paged attention (the ``paged`` kernel) at T 1 over a deep cache:
    GB/s of K/V traffic; beside ``bench_fa_decode`` bf16 it reads the paging
    overhead."""
    from ..ops.paged_attention import paged_flash_attention

    dev = resolve_device(device)
    H = Hkv * G
    n_pages = B * S // P + 1                     # +1: the NULL page at slot 0
    R = _target_sets(n_pages * Hkv * P * D * 4)
    pools = [(_randn((n_pages, Hkv, P, D), 100 + 2 * i, dev, torch.bfloat16),
              _randn((n_pages, Hkv, P, D), 101 + 2 * i, dev, torch.bfloat16))
             for i in range(R)]
    # page i+1 holds positions [i*P, (i+1)*P); the NULL page all -1
    page_pos = torch.cat([torch.full((1, P), -1, dtype=torch.int32, device=dev),
                          torch.arange(B * S, dtype=torch.int32, device=dev).reshape(-1, P)])
    table = torch.arange(B * (S // P), dtype=torch.int32, device=dev).reshape(B, -1) + 1
    q_pos = torch.full((B, 1), S - 1, dtype=torch.int32, device=dev)
    kv_bytes = (n_pages - 1) * Hkv * P * D * 2 * 2

    def step(q, _):
        for kp, vp in pools:
            o = paged_flash_attention(q, kp, vp, q_pos, page_pos, table).to(torch.float32)
            q = o / (1.0 + torch.abs(o))
        return q

    dt = chain_seconds(step, torch.ones((B, 1, H, D), device=dev), reps) / R
    return {"GBps": kv_bytes / dt / 1e9, "us_per_call": dt * 1e6,
            "shape": f"T1 S{S} P{P} H{H} D{D} bf16 pages", "device": device_name(dev)}


def cases(scale: float = 1.0, tiny: bool = False, device=None) -> list:
    """(name, thunk) of every entry: the JAX package's default shapes (its
    ``--small`` quarter with scale 0.25), or CPU-smoke shapes."""
    kw = {"device": device}
    if tiny:
        kw["reps"] = 1
        return [
            ("qmv_q4k_gemv", lambda: bench_qmv(N=256, K=512, **kw)),
            ("qmm_q4k_prefill", lambda: bench_qmm(M=32, N=256, K=512, **kw)),
            ("flash_attn_prefill", lambda: bench_fa_prefill(T=64, S=64, Hkv=2, G=2, D=64,
                                                            **kw)),
            *[(f"flash_attn_decode_{kv}",
               lambda kv=kv: bench_fa_decode(S=256, Hkv=2, G=2, D=64, kv=kv, **kw))
              for kv in ("q8", "q4", "bf16")],
            ("paged_attn_decode", lambda: bench_paged_attention(S=512, P=128, Hkv=2, G=2,
                                                                D=64, **kw)),
        ]
    return [
        ("qmv_q4k_gemv", lambda: bench_qmv(N=int(4096 * scale), K=4096, **kw)),
        ("qmm_q4k_prefill", lambda: bench_qmm(M=int(1024 * scale), N=int(4096 * scale),
                                              K=4096, **kw)),
        ("flash_attn_prefill", lambda: bench_fa_prefill(T=int(2048 * scale),
                                                        S=int(2048 * scale), **kw)),
        *[(f"flash_attn_decode_{kv}",
           lambda kv=kv: bench_fa_decode(S=int(8192 * scale), kv=kv, **kw))
          for kv in ("q8", "q4", "bf16")],
        ("paged_attn_decode", lambda: bench_paged_attention(S=int(8192 * scale), **kw)),
    ]


def run(small: bool = False, tiny: bool = False, device=None, out=DEFAULT_OUT) -> dict:
    """Every entry, one JSON line each as it finishes, then all of them in
    one line, also written to ``out``."""
    dev = resolve_device(device)
    res = {"device": device_name(dev)}
    for name, fn in cases(0.25 if small else 1.0, tiny, dev):
        res[name] = fn()
        print(json.dumps({name: res[name]}), flush=True)
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    print(f"wrote {path}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--small", action="store_true", help="a quarter of the default widths")
    ap.add_argument("--tiny", action="store_true", help="CPU-smoke shapes, one link each")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="JSON output path")
    args = ap.parse_args(argv)
    run(args.small, args.tiny, args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
