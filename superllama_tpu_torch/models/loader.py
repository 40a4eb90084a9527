"""GGUF → device params loader.

Counterpart of the JAX package's ``models/loader.py::load_model``: reads
tensors by name, keeps repackable 2-D matmul weights packed as QTensors
when asked (or dequantizes them), transposes matmul weights to (in, out)
so the forward uses ``x @ w`` (a 3-D one slice by slice, as JAX does), and
places every tensor on the device once. Norm biases, post-norms under their ecosystem,
legacy and unsuffixed names, the embedding norm, learned positions,
``attn_gate``, the sub-norms and MLA's ``wq_a`` / ``wq_b`` /
``attn_q_a_norm`` / ``wkv_a`` / ``wkv_b`` / ``attn_kv_a_norm`` load beside
the llama tensors, and so do the SSM ones (``ssm_in``, ``ssm_conv1d`` with
its bias, ``ssm_x``, ``ssm_dt`` with its bias, ``ssm_a``, ``ssm_d``,
``ssm_out``, ``ssm_norm``, the dt / B / C norms, qwen3next's ``ssm_ba``),
the RWKV block (``_RWKV_TENSORS``), lfm2's short conv (its final norm,
shipped as ``token_embd_norm``, moved to ``output_norm``) and gemma3n's
AltUp, LAUREL and per-layer-input tensors: the projections packed like any
2-D weight where their rows fit the format's blocks, the rest dense.
The MoE tensors: the router (``ffn_gate_inp`` with its bias, packed like
any 2-D weight), the selection bias ``exp_probs_b``, the expert banks
``ffn_{gate,up,down}_exps`` with their biases, grovemoe's chunk banks
``ffn_*_chexps``, the shared expert ``ffn_*_shexp`` with its gate and
arctic's ``ffn_norm_exps``. A bank (E, out, in) loads as a float (E, in,
out) tensor of the model's type, never packed, as the JAX loader packs only
2-D weights; it is decoded one expert at a time, so the host holds one
expert's f32 copy a worker, not the bank's (805 MB in f32 for one of
Qwen3-30B-A3B's).
A fused ``attn_qkv`` is read dequantized, as JAX reads it, and split into q
/ k / v; a fused gate ∥ up ``ffn_up`` is split by its GGUF rows before the
repack, so a packed one serves as two QTensors (the JAX loader leaves a
packed one fused, and its forward then fails on the widths).
The encoders (``bert.py::ENCODER_ARCHS``) load through the same branch with
their extras: token types, the classification head (``cls``, ``cls_out``
and their biases), the bert family's post-norms under their encoder names
(``attn_output_norm``, ``layer_output_norm``) with biases, jina-bert-v2's
``attn_norm_2`` and neo-bert's ``enc.output_norm``; nomic-bert-moe's expert
banks load as any bank. T5 (``t5``, ``t5encoder``) loads its ``enc.*`` and
``dec.*`` namespaces into ``enc_layers`` / ``dec_layers``, and the
WavTokenizer decoder (``wavtokenizer-dec``) its conv1d, posnet and convnext
tensors, always dense: its forward multiplies with ``@``, as the JAX one
does, and no packed weight could serve it.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf import GGUFReader
from ..gguf.quants import dequantize
from ..ops.qtensor import REPACKABLE, QTensor, repack
from ..server.security import decrypted
from .hparams import HParams, hparams_from_gguf
from .registry import check_loadable


@dataclass
class LoadedModel:
    hparams: HParams
    params: dict[str, Any]
    tokenizer: Any
    metadata: dict[str, Any]
    name: str = ""


# Tensors load on a pool of LOAD_WORKERS threads (numpy and the native
# library release the GIL in their array work). A native repack spreads one
# tensor over threads of its own: each gets cores // workers of them, so the
# pool and the library together keep each core busy once, with no more
# threads than cores.
LOAD_WORKERS = 8


def load_threads() -> tuple[int, int]:
    """(pool workers, native repack threads a worker) on this host."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else (
        os.cpu_count() or 1)
    workers = min(LOAD_WORKERS, cores)
    return workers, max(1, cores // workers)


def _get(reader: GGUFReader, name: str, dtype: torch.dtype, device,
         transpose: bool = True, keep_quantized: bool = False, threads: int = 0,
         rows: tuple[int, int] | None = None):
    """The tensor ``name`` on ``device`` (None when the file lacks it); with
    ``rows`` only GGUF rows (output features) [rows[0], rows[1]) of a 2-D
    weight, cut from the packed bytes before any repack."""
    ti = reader.tensors.get(name)
    if ti is None:
        return None
    raw, shape = ti.raw(), ti.shape
    if rows is not None:
        row_bytes = ti.n_bytes // shape[0]
        raw = raw[rows[0] * row_bytes:rows[1] * row_bytes]
        shape = (rows[1] - rows[0], shape[1])
    if (keep_quantized and transpose and len(ti.ne) == 2
            and ti.ggml_type in REPACKABLE):
        return repack(raw, ti.ggml_type, shape, device=device, threads=threads)
    arr = dequantize(raw, ti.ggml_type, shape)
    if transpose and arr.ndim == 2:
        arr = arr.T                       # (out, in) → (in, out)
    elif transpose and arr.ndim == 3:
        arr = arr.transpose(0, 2, 1)      # (n, out, in) → (n, in, out)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)


def _get_bank(reader: GGUFReader, name: str, dtype: torch.dtype, device):
    """The expert bank ``name`` (E, out, in) on ``device`` as (E, in, out)
    of ``dtype`` (None when the file lacks it), decoded one expert at a
    time."""
    ti = reader.tensors.get(name)
    if ti is None:
        return None
    E, n_out, n_in = ti.shape
    raw, per = ti.raw(), ti.n_bytes // E
    bank = torch.empty((E, n_in, n_out), dtype=dtype, device=device)
    for e in range(E):
        arr = dequantize(raw[e * per:(e + 1) * per], ti.ggml_type, (n_out, n_in))
        bank[e].copy_(torch.from_numpy(arr).T)
    return bank


def _first(*vals):
    for v in vals:
        if v is not None:
            return v
    return None


_BITNET_SCALED = (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
                  ("wo", "attn_output"), ("ffn_gate", "ffn_gate"),
                  ("ffn_up", "ffn_up"), ("ffn_down", "ffn_down"))


def _finish_layer(reader: GGUFReader, hp: HParams, il: int, layer: dict,
                  dtype: torch.dtype, dev) -> dict:
    """The loaded layer without its absent tensors, the fused qkv split into
    q / k / v (with its bias), bitnet's per-tensor scales folded into the
    weights and apertus' xIELU parameters attached."""
    p = f"blk.{il}."
    qkv, bqkv = layer.pop("qkv", None), layer.pop("bqkv", None)
    layer = {k: v for k, v in layer.items() if v is not None}
    if qkv is not None:                               # (E_in, (H + 2·Hkv)·D)
        nq = hp.n_head_il(il) * hp.head_dim
        nk = hp.n_head_kv_il(il) * hp.head_dim
        layer["wq"], layer["wk"], layer["wv"] = (
            qkv[:, :nq].contiguous(), qkv[:, nq:nq + nk].contiguous(),
            qkv[:, nq + nk:].contiguous())
        if bqkv is not None:
            layer["bq"], layer["bk"], layer["bv"] = (
                bqkv[:nq].contiguous(), bqkv[nq:nq + nk].contiguous(),
                bqkv[nq + nk:].contiguous())
    if hp.arch == "bitnet":
        # the optional per-tensor ternary scales ("blk.N.*.scale")
        for key, gname in _BITNET_SCALED:
            sc = _get(reader, p + gname + ".scale", dtype, dev, False)
            if sc is not None and key in layer:
                if isinstance(layer[key], QTensor):
                    raise NotImplementedError(
                        "bitnet scale folding needs dense weights; load with "
                        "keep_quantized=False")
                layer[key] = layer[key] * sc.reshape(())
    if hp.extra.get("xielu"):       # apertus: per-layer raw xIELU parameters
        layer["xielu"] = tuple(float(v[il]) for v in hp.extra["xielu"])
    return layer


# the RWKV block (rwkv6, rwkv7, arwkv7, rwkv6qwen2): (key, GGUF name, transposed)
_RWKV_TENSORS = (
    ("attn_norm_2", "attn_norm_2.weight", False), ("attn_norm_2_b", "attn_norm_2.bias", False),
    # the time mix (rwkv6's names; rwkv7 reuses key / value / receptance /
    # output / ln and adds the w / a / v / g low-rank stacks)
    *((f"time_mix_{n}", f"time_mix_{n}.weight", True) for n in (
        "w1", "w2", "decay_w1", "decay_w2", "key", "value", "receptance", "gate", "output",
        "a1", "a2", "v1", "v2", "g1", "g2")),
    *((f"time_mix_{n}", f"time_mix_{n}.weight", False) for n in (
        "lerp_x", "lerp_w", "lerp_k", "lerp_v", "lerp_r", "lerp_g", "lerp_fused", "first",
        "decay", "ln", "w0", "a0", "v0", "k_k", "k_a", "r_k")),
    # qrwkv's (rwkv6qwen2) optional r / k / v biases
    *((f"time_mix_{n}_b", f"time_mix_{n}.bias", False) for n in ("key", "value", "receptance")),
    ("time_mix_ln_b", "time_mix_ln.bias", False),
    # the channel mix
    ("channel_mix_lerp_k", "channel_mix_lerp_k.weight", False),
    ("channel_mix_lerp_r", "channel_mix_lerp_r.weight", False),
    *((f"channel_mix_{n}", f"channel_mix_{n}.weight", True) for n in (
        "key", "value", "receptance")),
)


def _rwkv_layer(g, p: str) -> dict:
    """The RWKV block's tensors of layer prefix p, as the JAX loader reads
    them (its 3-D ``time_mix_w2`` transposed to (5, extra, n_embd))."""
    return {key: g(p + name, t=t) for key, name, t in _RWKV_TENSORS}


def _resolve(obj):
    """``obj`` with every future replaced by its result."""
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v) for v in obj]
    return obj.result() if obj is not None else None


def _present(layer: dict) -> dict:
    return {k: v for k, v in layer.items() if v is not None}


# the bert family's extras (key, GGUF name): the post-norm LayerNorms under
# their encoder names with biases, jina-bert-v2's second attention norm
_BERT_TENSORS = (("attn_post_norm", "attn_output_norm.weight"),
                 ("attn_post_norm_b", "attn_output_norm.bias"),
                 ("ffn_post_norm", "layer_output_norm.weight"),
                 ("ffn_post_norm_b", "layer_output_norm.bias"),
                 ("attn_norm_2", "attn_norm_2.weight"), ("attn_norm_2_b", "attn_norm_2.bias"))
_BERT_ARCHS = ("bert", "nomic-bert", "nomic-bert-moe", "jina-bert-v2", "jina-bert-v3")

# the WavTokenizer decoder's tensors (key, GGUF name, transposed)
_WAV_GLOBALS = (("token_embd", "token_embd.weight", False), ("conv1d", "conv1d.weight", False),
                ("conv1d_b", "conv1d.bias", False),
                ("token_embd_norm", "token_embd_norm.weight", False),
                ("token_embd_norm_b", "token_embd_norm.bias", False),
                ("output_norm", "output_norm.weight", False),
                ("output_norm_b", "output_norm.bias", False),
                ("output", "output.weight", True), ("output_b", "output.bias", False))
_WAV_POSNET = (("norm1_w", "norm1.weight"), ("norm1_b", "norm1.bias"),
               ("conv1", "conv1.weight"), ("conv1_b", "conv1.bias"),
               ("norm2_w", "norm2.weight"), ("norm2_b", "norm2.bias"),
               ("conv2", "conv2.weight"), ("conv2_b", "conv2.bias"),
               ("attn_norm_w", "attn_norm.weight"), ("attn_norm_b", "attn_norm.bias"),
               ("attn_q", "attn_q.weight"), ("attn_q_b", "attn_q.bias"),
               ("attn_k", "attn_k.weight"), ("attn_k_b", "attn_k.bias"),
               ("attn_v", "attn_v.weight"), ("attn_v_b", "attn_v.bias"),
               ("attn_o", "attn_output.weight"), ("attn_o_b", "attn_output.bias"),
               ("norm_w", "norm.weight"), ("norm_b", "norm.bias"))
_WAV_CONVNEXT = (("dw", "dw.weight", False), ("dw_b", "dw.bias", False),
                 ("norm", "norm.weight", False), ("norm_b", "norm.bias", False),
                 ("pw1", "pw1.weight", True), ("pw1_b", "pw1.bias", False),
                 ("pw2", "pw2.weight", True), ("pw2_b", "pw2.bias", False),
                 ("gamma", "gamma.weight", False))


def _wavtokenizer_params(g, hp: HParams) -> dict:
    """The WavTokenizer decoder's params (futures), as the JAX loader names
    them (llama-model.cpp's tensor list)."""
    params = {key: g(name, t=t, kq=False) for key, name, t in _WAV_GLOBALS}
    params["posnet"] = [_present({key: g(f"posnet.{il}.{name}", t=False, kq=False)
                                  for key, name in _WAV_POSNET})
                        for il in range(hp.posnet_n_layer)]
    params["convnext"] = [_present({key: g(f"convnext.{il}.{name}", t=t, kq=False)
                                    for key, name, t in _WAV_CONVNEXT})
                          for il in range(hp.convnext_n_layer)]
    return params


# T5's layer tensors (key, GGUF name after the layer prefix, transposed)
_T5_ENC = (("attn_norm_enc", "attn_norm.weight", False), ("wq_enc", "attn_q.weight", True),
           ("wk_enc", "attn_k.weight", True), ("wv_enc", "attn_v.weight", True),
           ("wo_enc", "attn_o.weight", True), ("attn_rel_b_enc", "attn_rel_b.weight", False),
           ("ffn_norm_enc", "ffn_norm.weight", False), ("ffn_gate_enc", "ffn_gate.weight", True),
           ("ffn_up_enc", "ffn_up.weight", True), ("ffn_down_enc", "ffn_down.weight", True))
_T5_DEC = (("attn_norm", "attn_norm.weight", False), ("wq", "attn_q.weight", True),
           ("wk", "attn_k.weight", True), ("wv", "attn_v.weight", True),
           ("wo", "attn_o.weight", True), ("attn_rel_b", "attn_rel_b.weight", False),
           ("attn_norm_cross", "cross_attn_norm.weight", False),
           ("wq_cross", "cross_attn_q.weight", True), ("wk_cross", "cross_attn_k.weight", True),
           ("wv_cross", "cross_attn_v.weight", True), ("wo_cross", "cross_attn_o.weight", True),
           ("ffn_norm", "ffn_norm.weight", False), ("ffn_gate", "ffn_gate.weight", True),
           ("ffn_up", "ffn_up.weight", True), ("ffn_down", "ffn_down.weight", True))


def _t5_params(g, hp: HParams) -> dict:
    """T5's params (futures): the ``enc.*`` and ``dec.*`` namespaces
    (llama-arch.cpp), as the JAX loader names them."""
    params = {"token_embd": g("token_embd.weight", t=False), "output": g("output.weight"),
              "output_norm_enc": g("enc.output_norm.weight", t=False),
              "output_norm": g("dec.output_norm.weight", t=False)}
    params["enc_layers"] = [_present({key: g(f"enc.blk.{il}.{name}", t=t)
                                      for key, name, t in _T5_ENC})
                            for il in range(hp.n_layer)]
    params["dec_layers"] = [_present({key: g(f"dec.blk.{il}.{name}", t=t)
                                      for key, name, t in _T5_DEC})
                            for il in range(hp.dec_n_layer or hp.n_layer)]
    return params


def load_model(path: str, dtype: torch.dtype = torch.float32,
               keep_quantized: bool = False, device=None) -> LoadedModel:
    """Load a GGUF: hparams + tokenizer + params on ``device`` (default
    CUDA).

    keep_quantized=True keeps the matmul weights of every ``REPACKABLE``
    type packed as QTensors for the quantized kernels; other tensors are
    dequantized to ``dtype``. A split model loads from all its shards given
    the first one's path (``*-00001-of-0000N.gguf``, which carries the
    metadata). Tensors are decoded and repacked on a pool of threads
    (``load_threads``; Q4_0, Q8_0 and the K-quants through the native
    repack, bit-identical to numpy's). An encrypted GGUF
    (``server/security.py``'s AES-256-GCM container) is decrypted with
    ``SLT_MODEL_KEY`` to a temporary file, removed once the tensors are on
    the device."""
    dev = resolve_device(device)
    with decrypted(path) as plain:
        return _load(plain, dtype, keep_quantized, dev)


def _load(path: str, dtype: torch.dtype, keep_quantized: bool, dev) -> LoadedModel:
    reader = GGUFReader(path)
    extra: list[GGUFReader] = []
    workers, threads = load_threads()
    pool = ThreadPoolExecutor(max_workers=workers)
    try:
        if int(reader.metadata.get("split.count", 1) or 1) > 1:
            # a multi-shard model: merge the shards' tensor indices
            from ..tools.gguf_split import shard_paths

            for p in shard_paths(path):
                if p != path:
                    extra.append(GGUFReader(p))
                    reader.tensors.update(extra[-1].tensors)
        hp = hparams_from_gguf(reader)
        check_loadable(hp.arch)           # raises for a name no path runs
        tok = None
        if "tokenizer.ggml.tokens" in reader.metadata:
            from ..tokenizer import Tokenizer, vocab_from_gguf

            tok = Tokenizer(vocab_from_gguf(reader))

        def g(name, t=True, kq=keep_quantized):
            """A future of the tensor, or None when the file lacks it."""
            if name not in reader.tensors:
                return None
            return pool.submit(_get, reader, name, dtype, dev, t, kq, threads)

        def bank(name):
            """A future of the expert bank, or None when the file lacks it."""
            if name not in reader.tensors:
                return None
            return pool.submit(_get_bank, reader, name, dtype, dev)

        if hp.arch in ("wavtokenizer-dec", "t5", "t5encoder"):
            make = _wavtokenizer_params if hp.arch == "wavtokenizer-dec" else _t5_params
            params = _resolve(make(g, hp))
            if hp.arch == "wavtokenizer-dec":
                tok = None                # the JAX loader gives the codec none
            md = dict(reader.metadata)
            return LoadedModel(hparams=hp, params=params, tokenizer=tok, metadata=md,
                               name=md.get("general.name", ""))

        params: dict[str, Any] = {
            "token_embd": g("token_embd.weight", t=False),    # (V, E) lookup
            "output_norm": g("output_norm.weight", t=False),
            "output_norm_b": g("output_norm.bias", t=False),
            "output": g("output.weight"),                      # None → tied
            "output_b": g("output.bias", t=False),             # phi2 head bias
            "rope_freqs": g("rope_freqs.weight", t=False),     # llama3 factors
            "token_embd_norm": g("token_embd_norm.weight", t=False),   # bloom
            "token_embd_norm_b": g("token_embd_norm.bias", t=False),
            "position_embd": g("position_embd.weight", t=False),       # gpt2, bert
            # the encoders' token types and classification head
            "token_types": g("token_types.weight", t=False),
            "cls": g("cls.weight"),
            "cls_b": g("cls.bias", t=False),
            "cls_out": g("cls.output.weight"),
            "cls_out_b": g("cls.output.bias", t=False),
            # gemma3n's AltUp globals
            "per_layer_token_embd": g("per_layer_token_embd.weight", t=False),
            "per_layer_model_proj": g("per_layer_model_proj.weight"),
            "per_layer_proj_norm": g("per_layer_proj_norm.weight", t=False),
            "altup_proj": g("altup_proj.weight"),
            "altup_unembd_proj": g("altup_unembd_proj.weight"),
            "layers": [],
        }
        grok = hp.arch == "grok"
        for il in range(hp.n_layer):
            p = f"blk.{il}."
            layer = {
                "attn_norm": g(p + "attn_norm.weight", t=False),
                "attn_norm_b": g(p + "attn_norm.bias", t=False),
                "wq": g(p + "attn_q.weight"),
                "wk": g(p + "attn_k.weight"),
                "wv": g(p + "attn_v.weight"),
                "wo": g(p + "attn_output.weight"),
                "bq": g(p + "attn_q.bias", t=False),
                "bk": g(p + "attn_k.bias", t=False),
                "bv": g(p + "attn_v.bias", t=False),
                "bo": g(p + "attn_output.bias", t=False),
                "attn_q_norm": g(p + "attn_q_norm.weight", t=False),
                "attn_k_norm": g(p + "attn_k_norm.weight", t=False),
                "attn_q_norm_b": g(p + "attn_q_norm.bias", t=False),   # chameleon
                "attn_k_norm_b": g(p + "attn_k_norm.bias", t=False),
                "ffn_norm": g(p + "ffn_norm.weight", t=False),
                "ffn_norm_b": g(p + "ffn_norm.bias", t=False),
                "ffn_gate": g(p + "ffn_gate.weight"),
                "ffn_up": g(p + "ffn_up.weight"),
                "ffn_down": g(p + "ffn_down.weight"),
                "ffn_gate_b": g(p + "ffn_gate.bias", t=False),
                "ffn_up_b": g(p + "ffn_up.bias", t=False),
                "ffn_down_b": g(p + "ffn_down.bias", t=False),
                "attn_sinks": g(p + "attn_sinks.weight", t=False),
                # MLA (deepseek2, minicpm3, plm): the q LoRA, the KV latent
                # with k_pe, its norm and up-projection
                "wq_a": g(p + "attn_q_a.weight"),
                "wq_b": g(p + "attn_q_b.weight"),
                "attn_q_a_norm": g(p + "attn_q_a_norm.weight", t=False),
                "wkv_a": g(p + "attn_kv_a_mqa.weight"),
                "wkv_b": g(p + "attn_kv_b.weight"),
                "attn_kv_a_norm": g(p + "attn_kv_a_norm.weight", t=False),
                # post-norms (gemma2/3, olmo2, glm4): the ecosystem names, the
                # legacy ones, plamo3's unsuffixed ones and grok's
                "attn_post_norm": _first(
                    g(p + "post_attention_norm.weight", t=False),
                    g(p + "attn_post_norm.weight", t=False),
                    g(p + "post_attention_norm", t=False),
                    g(p + "attn_output_norm.weight", t=False) if grok else None),
                "ffn_post_norm": _first(
                    g(p + "post_ffw_norm.weight", t=False),
                    g(p + "ffn_post_norm.weight", t=False),
                    g(p + "post_ffw_norm", t=False),
                    g(p + "layer_output_norm.weight", t=False) if grok else None),
                "attn_gate": g(p + "attn_gate.weight"),      # σ-gated attention
                "attn_sub_norm": g(p + "attn_sub_norm.weight", t=False),   # bitnet
                "ffn_sub_norm": g(p + "ffn_sub_norm.weight", t=False),
                # MoE: the router, DeepSeek-V3's selection bias, the shared
                # expert and its gate, arctic's parallel-branch norm
                "ffn_gate_inp": g(p + "ffn_gate_inp.weight"),
                "ffn_gate_inp_b": g(p + "ffn_gate_inp.bias", t=False),
                "exp_probs_b": g(p + "exp_probs_b.bias", t=False),
                "ffn_gate_shexp": g(p + "ffn_gate_shexp.weight"),
                "ffn_up_shexp": g(p + "ffn_up_shexp.weight"),
                "ffn_down_shexp": g(p + "ffn_down_shexp.weight"),
                "ffn_gate_inp_shexp": g(p + "ffn_gate_inp_shexp.weight"),
                "ffn_norm_exps": g(p + "ffn_norm_exps.weight", t=False),
                # SSM (mamba, mamba2, plamo2 and the hybrids): the conv kernel
                # as (d_conv, channels); A and D with or without ".weight"
                # (the ecosystem's names carry none); the dt / B / C norms
                # under both names (plamo2's are suffix-less)
                "ssm_in": g(p + "ssm_in.weight"),
                "ssm_conv1d": g(p + "ssm_conv1d.weight"),
                "ssm_conv1d_b": g(p + "ssm_conv1d.bias", t=False),
                "ssm_x": g(p + "ssm_x.weight"),
                "ssm_dt": g(p + "ssm_dt.weight"),
                "ssm_dt_b": g(p + "ssm_dt.bias", t=False),
                "ssm_a": _first(g(p + "ssm_a", t=False), g(p + "ssm_a.weight", t=False)),
                "ssm_d": _first(g(p + "ssm_d", t=False), g(p + "ssm_d.weight", t=False)),
                "ssm_out": g(p + "ssm_out.weight"),
                "ssm_norm": g(p + "ssm_norm.weight", t=False),
                "ssm_dt_norm": _first(g(p + "ssm_dt_norm.weight", t=False),
                                      g(p + "ssm_dt_norm", t=False)),
                "ssm_b_norm": _first(g(p + "ssm_b_norm.weight", t=False),
                                     g(p + "ssm_b_norm", t=False)),
                "ssm_c_norm": _first(g(p + "ssm_c_norm.weight", t=False),
                                     g(p + "ssm_c_norm", t=False)),
                # qwen3next's gated delta net: the fused [beta | alpha] projection
                "ssm_beta_alpha": g(p + "ssm_ba.weight"),
                # gemma3n: the AltUp, LAUREL and per-layer-input tensors
                "altup_router": g(p + "altup_router.weight"),
                "altup_router_norm": g(p + "altup_router_norm.weight", t=False),
                "altup_predict_coef": g(p + "altup_predict_coef.weight"),
                "altup_correct_coef": g(p + "altup_correct_coef.weight"),
                "altup_correct_scale": g(p + "altup_correct_scale.weight", t=False),
                "per_layer_inp_gate": g(p + "inp_gate.weight"),
                "per_layer_proj": g(p + "proj.weight"),
                "per_layer_post_norm": g(p + "post_norm.weight", t=False),
                "laurel_l": g(p + "laurel_l.weight"),
                "laurel_r": g(p + "laurel_r.weight"),
                "laurel_post_norm": g(p + "laurel_post_norm.weight", t=False),
                # lfm2's short conv (the kernel as (L_cache, n_embd))
                "shortconv_conv": g(p + "shortconv.conv.weight"),
                "shortconv_in": g(p + "shortconv.in_proj.weight"),
                "shortconv_out": g(p + "shortconv.out_proj.weight"),
            }
            if hp.arch.startswith("rwkv") or hp.arch == "arwkv7":
                layer.update(_rwkv_layer(g, p))
            if hp.arch in _BERT_ARCHS:
                layer.update({key: g(p + name, t=False) for key, name in _BERT_TENSORS})
            for part in ("gate", "up", "down"):
                # the expert banks with their biases, grovemoe's chunk banks
                layer[f"ffn_{part}_exps"] = bank(p + f"ffn_{part}_exps.weight")
                layer[f"ffn_{part}_exps_b"] = g(p + f"ffn_{part}_exps.bias", t=False)
                layer[f"ffn_{part}_chexps"] = bank(p + f"ffn_{part}_chexps.weight")
            if layer["wq"] is None and hp.arch == "qwen3next" and hp.is_recurrent_layer(il):
                # qwen3next's delta-net attn_qkv: the fused [q | k | v]
                # linear-attention projection, read dequantized as JAX reads
                # it and never head-split
                layer["ssm_qkv"] = g(p + "attn_qkv.weight", kq=False)
            elif layer["wq"] is None:
                # a fused qkv (phi3, bloom, falcon…), read dequantized as JAX
                # reads it, split into q / k / v after the load
                layer["qkv"] = g(p + "attn_qkv.weight", kq=False)
                layer["bqkv"] = g(p + "attn_qkv.bias", t=False)
            up = reader.tensors.get(p + "ffn_up.weight")
            if (layer["ffn_gate"] is None and up is not None and hp.n_ff
                    and up.shape[0] == 2 * hp.n_ff):
                # a fused gate ∥ up (phi3, chatglm, glm4, plamo3): split by
                # GGUF rows, so a packed one becomes two QTensors
                layer["ffn_gate"], layer["ffn_up"] = (
                    pool.submit(_get, reader, up.name, dtype, dev, True, keep_quantized,
                                threads, rows=rows)
                    for rows in ((0, hp.n_ff), (hp.n_ff, 2 * hp.n_ff)))
            params["layers"].append(layer)
        if hp.arch == "neo-bert" and params["output_norm"] is None:
            # neo-bert ships its final RMS norm as enc.output_norm
            params["output_norm"] = g("enc.output_norm.weight", t=False)
        params = _resolve(params)
        params["layers"] = [_finish_layer(reader, hp, il, layer, dtype, dev)
                            for il, layer in enumerate(params["layers"])]
        if hp.arch in ("lfm2", "lfm2moe") and params["output_norm"] is None:
            # lfm2 ships its final norm as "token_embd_norm"
            # (llama-arch.cpp LLM_TENSOR_OUTPUT_NORM_LFM2)
            params["output_norm"], params["token_embd_norm"] = params["token_embd_norm"], None
        md = dict(reader.metadata)
    finally:
        pool.shutdown(cancel_futures=True)   # no thread reads a file past here
        for r in [reader, *extra]:
            r.close()
    return LoadedModel(hparams=hp, params=params, tokenizer=tok, metadata=md,
                       name=md.get("general.name", ""))


def load_tokenizer(path: str):
    """The GGUF's tokenizer alone (no tensor is read), or None when it has
    none; an encrypted file is decrypted as ``load_model`` does."""
    from ..tokenizer import Tokenizer, vocab_from_gguf

    with decrypted(path) as plain:
        reader = GGUFReader(plain)
        try:
            if "tokenizer.ggml.tokens" not in reader.metadata:
                return None
            return Tokenizer(vocab_from_gguf(reader))
        finally:
            reader.close()
