"""WavTokenizer decoder: audio codes → STFT-frame embeddings.

Counterpart of the JAX package's ``models/wavtokenizer.py`` (the
reference's wavtokenizer-dec.cpp): code embeddings → conv1d (k 7) → the
posnet (ResNet blocks, one single-head attention block, a final group norm)
→ the token LayerNorm → the ConvNeXt stack (depthwise k 7, LayerNorm, pw1,
tanh GELU, pw2, × gamma) → the final LayerNorm → the output head, whose
(T, n_fft / 2 + 1 magnitudes ∥ phases) ``tools/tts.embd_to_audio`` turns
into audio.

The convolutions are ``torch.nn.functional.conv1d`` with SAME padding (the
JAX ``conv_general_dilated``); the GGUF's conv weights (C_out, C_in / groups,
K) are already its layout. No Pallas kernel here, so none in the port: the
convs are a held item of ROADMAP §2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import ref as ops
from .hparams import HParams


def _conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                 groups: int = 1) -> torch.Tensor:
    """x (B, T, C_in); w (C_out, C_in / groups, K); SAME padding."""
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), None, padding="same", groups=groups)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.reshape(-1)
    return y


def _group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n_groups: int,
                eps: float) -> torch.Tensor:
    """GroupNorm over (T, C / G) of each group (ggml_group_norm); x (B, T, C)."""
    B, T, C = x.shape
    g = x.reshape(B, T, n_groups, C // n_groups).to(torch.float32)
    mu = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    g = ((g - mu) * torch.rsqrt(var + eps)).reshape(B, T, C).to(x.dtype)
    return g * w.reshape(-1) + b.reshape(-1)


def wavtokenizer_decode(params: dict, hp: HParams, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, T) → (B, T, n_embd_out) STFT-frame embeddings."""
    def gn(x, layer, p):
        return _group_norm(x, layer[p + "_w"], layer[p + "_b"], hp.n_norm_groups,
                           hp.f_norm_group_eps)

    x = params["token_embd"][codes.to(torch.int64)]          # (B, T, features)
    x = _conv1d_same(x, params["conv1d"], params.get("conv1d_b"))

    for layer in params["posnet"]:
        inp = x
        if "norm1_w" in layer:                                # ResNet block
            h = gn(x, layer, "norm1")
            h = h * torch.sigmoid(h)                          # swish
            h = _conv1d_same(h, layer["conv1"], layer.get("conv1_b"))
            h = gn(h, layer, "norm2")
            h = h * torch.sigmoid(h)
            h = _conv1d_same(h, layer["conv2"], layer.get("conv2_b"))
            x = h + inp
        elif "attn_q" in layer:                               # attention block
            h = gn(x, layer, "attn_norm")
            q = _conv1d_same(h, layer["attn_q"], layer.get("attn_q_b"))
            k = _conv1d_same(h, layer["attn_k"], layer.get("attn_k_b"))
            v = _conv1d_same(h, layer["attn_v"], layer.get("attn_v_b"))
            scores = torch.einsum("btc,bsc->bts", q.to(torch.float32), k.to(torch.float32))
            p = torch.softmax(scores / (q.shape[-1] ** 0.5), dim=-1)
            h = torch.einsum("bts,bsc->btc", p.to(x.dtype), v)
            h = _conv1d_same(h, layer["attn_o"], layer.get("attn_o_b"))
            x = h + inp
        else:                                                 # final group norm
            x = gn(x, layer, "norm")

    x = ops.layer_norm(x, params["token_embd_norm"].reshape(-1),
                       params["token_embd_norm_b"].reshape(-1), hp.norm_eps)

    for layer in params["convnext"]:
        h = _conv1d_same(x, layer["dw"], layer.get("dw_b"), groups=x.shape[-1])
        h = ops.layer_norm(h, layer["norm"], layer.get("norm_b"), hp.norm_eps)
        h = ops.gelu(h @ layer["pw1"] + layer["pw1_b"])
        h = h @ layer["pw2"] + layer["pw2_b"]
        x = x + h * layer["gamma"]

    x = ops.layer_norm(x, params["output_norm"], params.get("output_norm_b"), hp.norm_eps)
    x = x @ params["output"]
    if params.get("output_b") is not None:
        x = x + params["output_b"]
    return x
