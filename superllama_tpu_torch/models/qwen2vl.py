"""Multimodal rotary embedding (Qwen2-VL M-RoPE, Qwen3-VL IMROPE).

Counterpart of the rotary half of the JAX package's ``models/qwen2vl.py``
(``mrope_apply`` and ``_imrope_owner``): the language model applies it over
(temporal, height, width) position streams. The vision tower is not ported
yet. Every index table is built on the tensors' device, so a step captured
as a CUDA graph copies nothing from the host.
"""

from __future__ import annotations

import torch


def _imrope_owner(sections, half: int, device=None) -> torch.Tensor:
    """Interleaved owner per frequency slot (Qwen3-VL IMROPE,
    ggml-cpu/ops.cpp:5600), computed on ``device``: slot s → h when s%3==1 ∧
    s<3·sec[1], w when s%3==2 ∧ s<3·sec[2], t when s%3==0 ∧ s<3·sec[0],
    else the fourth stream (0 for text tokens)."""
    s = torch.arange(half, device=device)
    own = torch.full_like(s, 3)
    for stream in range(3):       # t, h, w own the slots s % 3 == 0, 1, 2
        own = torch.where((s % 3 == stream) & (s < 3 * int(sections[stream])), stream, own)
    return own


def mrope_apply(x: torch.Tensor, pos3: torch.Tensor, inv_freq: torch.Tensor,
                sections, interleaved: bool = False) -> torch.Tensor:
    """Multimodal rotary: x (B, T, H, D); pos3 (3, B, T) temporal / height /
    width positions; ``sections`` the quarter-dim counts per stream (HF
    mrope_section, e.g. (16, 24, 24) for D 128). Each frequency slot takes
    the position stream its section owns; the layout is NEOX (half-split
    rotate). ``interleaved`` selects the Qwen3-VL IMROPE mapping."""
    D = x.shape[-1]
    half = D // 2
    B, T = pos3.shape[1], pos3.shape[2]
    if pos3.shape[0] == 3:   # stream 3 ("e") is all-zero for text tokens
        pos3 = torch.cat([pos3, torch.zeros_like(pos3[:1])], dim=0)
    angles = pos3[..., None].to(torch.float32) * inv_freq     # (4, B, T, half)
    if interleaved:
        own = _imrope_owner(sections, half, x.device)
    else:    # np.repeat(arange(3), sections): contiguous sections
        s = torch.arange(half, device=x.device)
        own = (s >= int(sections[0])).to(torch.int64) + (
            s >= int(sections[0]) + int(sections[1])).to(torch.int64)
    ang = torch.gather(angles, 0, own.view(1, 1, 1, half).expand(1, B, T, half))[0]
    cos = torch.cos(ang)[:, :, None, :]                        # (B, T, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)
