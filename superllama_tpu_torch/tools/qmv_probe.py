"""GEMV kernel-variant probe: which formulation of the Q4_K int8-activation
decode GEMV gets closest to the weight-bytes bound on the card.

Counterpart of the JAX package's ``tools/qmv_probe.py``: the same math on the
production Q4_K compact layout, timed in five formulations:

  v0  the port's decode GEMV, ``ops/qmatmul.qmv`` (``csrc/qmv.cu``)
  v1  one batched integer dot over the group axis: codes unpacked to a
      ``[lo‖hi]`` buffer, dotted with activations laid out (G, M, 32)
  v2  lo/hi nibble-split dots, dot(x_lo, c & 0xF) + dot(x_hi, c >> 4), with
      no ``[lo‖hi]`` concat
  v3  v1 with a k-split grid: each 1024-wide K chunk reduced on its own,
      the chunks added in order
  v4  v1 with the nibble mask done on 8-bit lanes

v1-v4 are the hand-written CUDA kernels of ``csrc/qmv_probe.cu``.
``qmv_variant`` prepares the activations with torch ops (``prep_acts``; the
JAX package does this in XLA outside its ``pallas_call``) and launches the
variant's kernel (``launch_variant``) on CUDA tensors; on CPU tensors it runs
``qmv_variant_plain``, the variant's math step by step. Launches are counted
per variant in ``qmv_variant.launches``.

Each variant is checked against ``qmatmul_ref`` (NMSE ≤ 1e-4) before it is
timed on a data-dependent chain over R distinct weights (32 × 9.96 MB at the
default shape, far above the card's 50 MB L2: every call streams its weight
from device memory).

Run: python -m superllama_tpu_torch.tools.qmv_probe [N K [v0,v1,...]]
     [--device cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..device import resolve_device
from ..gguf.constants import GGMLType
from ..ops import _build
from ..ops.qmatmul import qmatmul_ref, qmv, quantize_acts
from ..ops.qtensor import QTensor
from .ops_bench import chain_seconds, device_name, q4k_device

GS, SB = 32, 8           # Q4_K: 32-element groups, 8 groups per superblock
CHUNK = 1024             # v3's K chunk
VARIANTS = ("v1", "v2", "v3", "v4")
MAX_ROWS = 16            # rows per kernel launch
NMSE_GATE = 1e-4         # against qmatmul_ref: the int8 activation budget

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"v1": [_I] * 3 + [_P] * 10, "v4": [_I] * 3 + [_P] * 10,
             "v2": [_I] * 3 + [_P] * 11, "v3": [_I] * 3 + [_P] * 11}


def _check(x2: torch.Tensor, qt: QTensor, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {', '.join(VARIANTS)}")
    if (qt.ggml_type != GGMLType.Q4_K or not qt.nibble or qt.group != GS or qt.sb != SB
            or any(p is None for p in (qt.sc, qt.mn, qt.d, qt.dmin))):
        raise ValueError(f"the probe variants take a Q4_K weight in the compact "
                         f"layout, not {qt.ggml_type.name}")
    if x2.ndim != 2 or x2.shape[1] != qt.K:
        raise ValueError(f"x {tuple(x2.shape)} does not match the weight's K={qt.K}")
    if variant == "v3" and qt.K % CHUNK:
        raise ValueError(f"v3 splits K into {CHUNK}-element chunks; K={qt.K} is not "
                         f"a multiple")


# --- activations -------------------------------------------------------------


def prep_acts(x2: torch.Tensor, variant: str) -> tuple:
    """(M, K) activations → the variant's kernel inputs: int8 codes laid out
    (G, M, 32) (v2: their low and high halves, (G, M, 16) each) and the f32
    scales sx and group sums xs, (M, G) (v3: (K/1024, M, 32))."""
    M, K = x2.shape
    G = K // GS
    xq, sx, xs = quantize_acts(x2, GS)
    xg = xq.reshape(M, G, GS).transpose(0, 1)
    if variant == "v2":
        return xg[:, :, :16].contiguous(), xg[:, :, 16:].contiguous(), sx, xs
    if variant == "v3":
        n_k = K // CHUNK
        chunked = lambda t: t.reshape(M, n_k, CHUNK // GS).transpose(0, 1).contiguous()
        return xg.contiguous(), chunked(sx), chunked(xs)
    return xg.contiguous(), sx, xs


# --- plain versions ------------------------------------------------------------


def _scales(sc, mn, d, dmin):
    """Per-group scale s = d·sc and add a = −(dmin·mn), (G, N) f32."""
    s = d.repeat_interleave(SB, dim=0) * sc.to(torch.float32)
    a = -(dmin.repeat_interleave(SB, dim=0) * mn.to(torch.float32))
    return s, a


def _reduce(ig, sx, s, a, xs):
    """y[m,n] = Σ_g (ig[g,m,n]·s[g,n])·sx[m,g] + xs @ a."""
    acc = (ig * s[:, None, :] * sx.t()[:, :, None]).sum(dim=0)
    return acc + xs @ a


def _idot(x8: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """Batched integer dot (G, M, w) · (G, w, N) → (G, M, N), as an f32
    matmul: |dot| ≤ 32·127·15 < 2^24, so products and sums are exact."""
    return torch.matmul(x8.to(torch.float32), q8.to(torch.float32))


def qmv_variant_plain(x2: torch.Tensor, qt: QTensor, variant: str) -> torch.Tensor:
    """Plain version of a variant's kernel: its math step by step, f32 out."""
    _check(x2, qt, variant)
    N = qt.N
    acts = prep_acts(x2, variant)
    p = qt.codes.reshape(-1, 16, N).to(torch.int32)                  # (G, 16, N)
    if variant == "v2":
        xl, xh, sx, xs = acts
        ig = (_idot(xl, (p & 0x0F).to(torch.int8))
              + _idot(xh, (p >> 4).to(torch.int8)))
        return _reduce(ig, sx, *_scales(qt.sc, qt.mn, qt.d, qt.dmin), xs)
    if variant == "v4":
        xg, sx, xs = acts
        lo = qt.codes.reshape(-1, 16, N).view(torch.int8) & 0x0F       # int8 bitwise
        q = torch.cat([lo, (p >> 4).to(torch.int8)], dim=1)
        return _reduce(_idot(xg, q), sx, *_scales(qt.sc, qt.mn, qt.d, qt.dmin), xs)
    q = torch.cat([p & 0x0F, p >> 4], dim=1).to(torch.int8)           # (G, 32, N)
    if variant == "v1":
        xg, sx, xs = acts
        return _reduce(_idot(xg, q), sx, *_scales(qt.sc, qt.mn, qt.d, qt.dmin), xs)
    xg, sx3, xs3 = acts                                              # v3
    gk, gd = CHUNK // GS, CHUNK // (GS * SB)
    acc = torch.zeros((x2.shape[0], N), dtype=torch.float32, device=x2.device)
    for k in range(qt.K // CHUNK):
        g, sb = slice(k * gk, (k + 1) * gk), slice(k * gd, (k + 1) * gd)
        s, a = _scales(qt.sc[g], qt.mn[g], qt.d[sb], qt.dmin[sb])
        acc = acc + _reduce(_idot(xg[g], q[g]), sx3[k], s, a, xs3[k])
    return acc


# --- kernels -------------------------------------------------------------------


def _check_cuda(x2: torch.Tensor, qt: QTensor) -> None:
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be f32 or bf16, got {x2.dtype}")
    if x2.shape[0] > MAX_ROWS:
        raise ValueError(f"a probe kernel launch takes at most {MAX_ROWS} rows, "
                         f"got {x2.shape[0]}")
    if qt.N % 4:
        raise ValueError(f"the probe kernels read 4 columns per thread: N={qt.N} "
                         f"is not a multiple of 4")
    want = {"codes": torch.uint8, "sc": torch.uint8, "mn": torch.uint8,
            "d": torch.float32, "dmin": torch.float32}
    for name, dt in want.items():
        plane = getattr(qt, name)
        if plane.dtype != dt or plane.device != x2.device or not plane.is_contiguous():
            raise ValueError(f"weight plane {name} must be a contiguous {dt} tensor "
                             f"on {x2.device}")


def launch_variant(acts: tuple, qt: QTensor, variant: str) -> torch.Tensor:
    """The variant's kernel on activations from ``prep_acts`` of at most 16
    rows, checked by ``qmv_variant``: f32 (M, N)."""
    lib = _build.load("qmv_probe")
    fn = getattr(lib, f"slt_qmv_probe_{variant}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[variant]
        fn.restype = ctypes.c_int
    M = acts[0].shape[1]
    dev = acts[0].device
    out = torch.empty((M, qt.N), dtype=torch.float32, device=dev)
    weights = [qt.codes.data_ptr(), qt.sc.data_ptr(), qt.mn.data_ptr(), qt.d.data_ptr(),
               qt.dmin.data_ptr()]
    tail = [out.data_ptr(), _build.stream_ptr(dev)]
    if variant == "v3":
        part = torch.empty((qt.K // CHUNK, M, qt.N), dtype=torch.float32, device=dev)
        tail.insert(0, part.data_ptr())
    err = fn(M, qt.K, qt.N, *(t.data_ptr() for t in acts), *weights, *tail)
    _build.check(err, f"qmv_probe {variant}")
    qmv_variant.launches[variant] += 1
    return out


def qmv_variant(x2: torch.Tensor, qt: QTensor, variant: str) -> torch.Tensor:
    """x2 (M, K) f32/bf16 @ Q4_K (K, N) → f32 (M, N) by one of the probe's
    formulations. CUDA: prep with torch ops, then the variant's kernel (M at
    most 16); CPU: ``qmv_variant_plain``."""
    if x2.device.type == "cpu":
        return qmv_variant_plain(x2, qt, variant)
    if x2.device.type != "cuda":
        raise ValueError(f"qmv_variant runs on cuda or cpu tensors, not {x2.device}")
    _check(x2, qt, variant)
    _check_cuda(x2, qt)
    return launch_variant(prep_acts(x2, variant), qt, variant)


qmv_variant.launches = dict.fromkeys(VARIANTS, 0)


# --- the probe -----------------------------------------------------------------


def nmse(got: torch.Tensor, ref: torch.Tensor) -> float:
    g, r = got.double(), ref.double()
    return float(((g - r) ** 2).mean() / (r ** 2).mean())


def _fn(name: str):
    if name == "v0":
        return lambda x, qt: qmv(x, qt, torch.float32)
    return lambda x, qt: qmv_variant(x, qt, name)


def run(N=4096, K=4096, variants=("v0", "v1", "v2", "v3", "v4"), M=8, R=32, reps=20,
        device=None) -> dict:
    """Check each variant against ``qmatmul_ref``, then time it over R
    distinct weights: one line per variant and one JSON line."""
    dev = resolve_device(device)
    qts = [q4k_device(N, K, seed=i, device=dev) for i in range(R)]
    wbytes = qts[0].nbytes
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x0 = torch.randn((M, K), generator=g, device=dev)
    ref = qmatmul_ref(x0, qts[0])
    rows = []
    for name in variants:
        fn = _fn(name)
        e = nmse(fn(x0, qts[0]), ref)
        if not e <= NMSE_GATE:
            raise AssertionError(f"{name}: WRONG nmse={e:.2e} against qmatmul_ref")

        def step(x, _):
            for qt in qts:
                y = fn(x, qt)
                x = y.repeat(1, -(-K // N))[:, :K]
                x = x / (1.0 + torch.abs(x))
            return x

        dt = chain_seconds(step, x0 + 0.03, reps) / R
        rows.append({"variant": name, "us_per_call": dt * 1e6,
                     "GBps": wbytes / dt / 1e9, "nmse": e})
        print(f"{name}: {dt * 1e6:8.2f} us  {wbytes / dt / 1e9:7.1f} GB/s  nmse={e:.1e}",
              flush=True)
    res = {"qmv_probe": {"N": N, "K": K, "M": M, "R": R, "weight_bytes": wbytes,
                         "device": device_name(dev), "rows": rows}}
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("N", type=int, nargs="?", default=4096)
    ap.add_argument("K", type=int, nargs="?", default=4096)
    ap.add_argument("variants", nargs="?", default="v0,v1,v2,v3,v4")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-smoke shape: N 256, K 1024, M 4, 2 weights, one link")
    args = ap.parse_args(argv)
    variants = tuple(args.variants.split(","))
    if args.tiny:
        run(256, 1024, variants, M=4, R=2, reps=1, device=args.device)
    else:
        run(args.N, args.K, variants, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
