"""GGUF → GGUF re-quantization tool.

The port's copy of the JAX package's ``tools/quantize.py`` (counterpart of
llama_model_quantize_impl, src/llama-quant.cpp:482, and the llama-quantize
CLI): stream tensors from a source GGUF through the port's reader, choose a
per-tensor target type (standard rules + user overrides), dequantize →
requantize (the native encoders where they cover the type, the numpy ones
otherwise; the imatrix-weighted K-quant searches in numpy, as in the JAX
package), optionally importance-weighted by an imatrix (per-input-channel
Σx² statistics, ``imatrix.py``), and write with the port's GGUFWriter.
"""

from __future__ import annotations

import fnmatch
import re

import numpy as np

from ..gguf import GGMLType, GGUFReader, GGUFWriter
from ..gguf.quants import QUANTIZERS, dequantize, quantize

# mixture presets: per-tensor type rules in priority order, mirroring the
# spirit of llama-quant.cpp's llama_tensor_get_type defaults
_FTYPE_RULES: dict[str, list[tuple[str, GGMLType]]] = {
    "Q4_0": [("output.weight", GGMLType.Q6_K), ("token_embd.weight", GGMLType.Q4_0)],
    "Q8_0": [],
    "Q4_K_M": [
        ("output.weight", GGMLType.Q6_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.Q6_K),
        (r"blk\.\d+\.attn_v.*", GGMLType.Q6_K),
    ],
    "Q5_K_M": [
        ("output.weight", GGMLType.Q6_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.Q6_K),
        (r"blk\.\d+\.attn_v.*", GGMLType.Q6_K),
    ],
    "Q6_K": [("output.weight", GGMLType.Q6_K)],
    "MXFP4": [("output.weight", GGMLType.Q8_0), ("token_embd.weight", GGMLType.Q8_0)],
    "IQ4_XS": [
        ("output.weight", GGMLType.Q6_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.Q5_K),
    ],
    # i-quant mixtures mirror llama_tensor_get_type's low-bit defaults:
    # embeddings/head and ffn_down get a tier or two more bits
    "IQ3_S": [
        ("output.weight", GGMLType.Q5_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.IQ4_XS),
        (r"blk\.\d+\.attn_v.*", GGMLType.IQ4_XS),
    ],
    "IQ3_XXS": [
        ("output.weight", GGMLType.Q5_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.IQ3_S),
        (r"blk\.\d+\.attn_v.*", GGMLType.IQ3_S),
    ],
    "IQ2_S": [
        ("output.weight", GGMLType.Q5_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.IQ3_S),
        (r"blk\.\d+\.attn_v.*", GGMLType.IQ3_S),
    ],
    "IQ2_XS": [
        ("output.weight", GGMLType.Q5_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.IQ3_XXS),
        (r"blk\.\d+\.attn_v.*", GGMLType.IQ3_XXS),
    ],
    "IQ2_XXS": [
        ("output.weight", GGMLType.Q5_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.IQ3_XXS),
        (r"blk\.\d+\.attn_v.*", GGMLType.IQ3_XXS),
    ],
    "IQ1_S": [
        ("output.weight", GGMLType.Q5_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.IQ2_S),
        (r"blk\.\d+\.attn_v.*", GGMLType.IQ2_S),
    ],
    "IQ1_M": [
        ("output.weight", GGMLType.Q5_K),
        ("token_embd.weight", GGMLType.Q4_K),
        (r"blk\.\d+\.ffn_down.*", GGMLType.IQ2_S),
        (r"blk\.\d+\.attn_v.*", GGMLType.IQ2_S),
    ],
    "TQ1_0": [("output.weight", GGMLType.Q6_K),
              ("token_embd.weight", GGMLType.Q4_K)],
    "TQ2_0": [("output.weight", GGMLType.Q6_K),
              ("token_embd.weight", GGMLType.Q4_K)],
}
_FTYPE_DEFAULT = {
    "Q4_0": GGMLType.Q4_0, "Q8_0": GGMLType.Q8_0, "Q4_K_M": GGMLType.Q4_K,
    "Q5_K_M": GGMLType.Q5_K, "Q6_K": GGMLType.Q6_K, "MXFP4": GGMLType.MXFP4,
    "IQ4_XS": GGMLType.IQ4_XS,
    "IQ3_S": GGMLType.IQ3_S, "IQ3_XXS": GGMLType.IQ3_XXS,
    "IQ2_S": GGMLType.IQ2_S, "IQ2_XS": GGMLType.IQ2_XS,
    "IQ2_XXS": GGMLType.IQ2_XXS,
    "IQ1_S": GGMLType.IQ1_S, "IQ1_M": GGMLType.IQ1_M,
    "TQ1_0": GGMLType.TQ1_0, "TQ2_0": GGMLType.TQ2_0,
}


def _pick_type(name: str, ne: tuple[int, ...], ftype: str,
               overrides: list[tuple[str, GGMLType]]) -> GGMLType:
    if len(ne) == 1 or name.endswith("_norm.weight") or name.endswith(".bias") \
            or name.endswith("attn_sinks.weight"):
        return GGMLType.F32
    t = None
    for pat, cand in overrides:
        if fnmatch.fnmatch(name, pat) or re.fullmatch(pat, name):
            t = cand
            break
    if t is None:
        for pat, cand in _FTYPE_RULES[ftype]:
            if re.fullmatch(pat, name) or pat == name:
                t = cand
                break
    if t is None:
        t = _FTYPE_DEFAULT[ftype]
    # rows must fit the block size; fall back like the reference does
    from ..gguf.constants import GGML_TYPE_TRAITS
    if ne[0] % GGML_TYPE_TRAITS[t].block_size != 0:
        for fb in (GGMLType.Q8_0, GGMLType.F16):
            if ne[0] % GGML_TYPE_TRAITS[fb].block_size == 0:
                return fb
        return GGMLType.F16
    return t


def _weighted_rescale(x: np.ndarray, packed: np.ndarray, t: GGMLType,
                      weights: np.ndarray) -> np.ndarray:
    """Importance-weighted refinement: per block, search clipped encodings —
    shrinking a block's max shrinks its scale, buying resolution for
    small-magnitude high-importance channels at the cost of clipping
    unimportant outliers (the weighted-search idea of make_qx_quants with
    imatrix, done as a per-block clip-factor sweep)."""
    from ..gguf.constants import GGML_TYPE_TRAITS
    tr = GGML_TYPE_TRAITS[t]
    if t not in (GGMLType.Q4_0, GGMLType.Q5_0, GGMLType.Q8_0, GGMLType.IQ4_NL,
                 GGMLType.MXFP4):
        # K-quants already ran the imatrix-weighted search encoders
        # (gguf/kquant_search.py) inside quantize(); nothing to refine here
        return packed
    blck, tsz = tr.block_size, tr.type_size
    xb = x.reshape(-1, blck).astype(np.float32)
    wb = np.broadcast_to(weights, x.shape).reshape(-1, blck).astype(np.float32)
    best = packed.reshape(-1, tsz).copy()
    best_err = ((xb - dequantize(packed, t).reshape(-1, blck)) ** 2 * wb).sum(1)
    amax = np.abs(xb).max(axis=1, keepdims=True)
    for f in (0.5, 0.65, 0.8, 0.9):
        lim = amax * f
        cand = quantize(np.clip(xb, -lim, lim).reshape(x.shape), t)
        err = ((xb - dequantize(cand, t).reshape(-1, blck)) ** 2 * wb).sum(1)
        better = err < best_err
        if better.any():
            best[better] = cand.reshape(-1, tsz)[better]
            best_err = np.where(better, err, best_err)
    return best.reshape(-1)


def quantize_model(
    in_path: str,
    out_path: str,
    ftype: str = "Q4_K_M",
    imatrix: dict[str, np.ndarray] | None = None,
    overrides: list[tuple[str, GGMLType]] | None = None,
    progress=None,
) -> dict:
    """Re-quantize a GGUF model file. Returns per-type tensor counts."""
    if ftype not in _FTYPE_DEFAULT:
        raise ValueError(f"unknown ftype {ftype!r}; known: {sorted(_FTYPE_DEFAULT)}")
    r = GGUFReader(in_path)
    arch = r.metadata["general.architecture"]
    w = GGUFWriter(out_path, arch=arch)
    for k, v in r.metadata.items():
        if k != "general.architecture":
            w.add(k, v)
    w.add("general.file_type_name", ftype)

    stats: dict[str, int] = {}
    for name, ti in r.tensors.items():
        t = _pick_type(name, ti.ne, ftype, overrides or [])
        if t == ti.ggml_type:
            w.add_tensor(name, ti.raw().copy(), t, raw_ne=ti.ne)
        else:
            x = ti.astype_f32()
            if t in (GGMLType.F32,):
                w.add_tensor(name, x, t)
            elif t == GGMLType.F16:
                w.add_tensor(name, x, GGMLType.F16)
            else:
                if t not in QUANTIZERS:
                    raise ValueError(f"no encoder for {t.name}")
                qw = None
                if imatrix is not None and name in imatrix:
                    qw = np.broadcast_to(
                        np.asarray(imatrix[name], np.float32), (ti.ne[0],))
                # K-quants run the imatrix-weighted search directly
                # (quantize_row_*_K_impl); other formats encode plain and
                # get the clip-factor weighted rescale below
                packed = quantize(x, t, qw=qw)
                if qw is not None:
                    packed = _weighted_rescale(x, packed, t, imatrix[name])
                w.add_tensor(name, packed, t, raw_ne=ti.ne)
        stats[t.name] = stats.get(t.name, 0) + 1
        if progress:
            progress(name, t.name)
    r.close()
    w.write()
    return stats
