"""The linear-attention recurrences: RWKV-6's wkv6, qrwkv's gated linear
attention (gla), RWKV-7's wkv7 and Qwen3-Next's gated delta net.

Counterparts of the JAX package's ``jax.lax.scan`` recurrences
(``superllama_tpu/models/rwkv.py:39`` wkv6, ``:58`` wkv7, ``:78`` gla;
``superllama_tpu/models/qwen3next.py:41`` delta_net), with their argument
order and state layouts: wkv6, gla and the delta net keep S[i=key, j=val],
wkv7 S[i=val, j=key], each (B, H, D, D).

On CUDA tensors each function launches the hand-written kernel of
``csrc/wkv.cu`` (one source, a rule a template instance), counted in its
own ``launches``; on CPU tensors it runs its plain loop (``ops/ref.py``).
The state is written in place in its cache type (f32, or bf16 for the
delta net), and a row whose ``active`` flag is False keeps it (y 0 there):
the JAX engine's ``mask_rows``, done inside the step. Nothing is read on
the host, so a CUDA graph captures each call. Each returns y (B, T, H, D)
f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import delta_inputs, delta_net_plain, gla_plain, wkv6_plain, wkv7_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I] * 8 + [ctypes.c_float] + [_P] * 13
_STATE = {torch.float32: 0, torch.bfloat16: 1}
_RULE = {"wkv6": 0, "gla": 1, "wkv7": 2, "delta_net": 3}
MAX_VALUES = 16         # state values a thread holds
MAX_HEAD = 128          # the kernel's largest head size


def wkv_split(D: int) -> tuple[int, int]:
    """(lanes, values a lane) of a state vector of D: 16 a lane where D is
    16 x a power of two up to 128, else one lane of D <= 16."""
    if D % MAX_VALUES == 0:
        lanes = D // MAX_VALUES
        if lanes <= MAX_HEAD // MAX_VALUES and lanes & (lanes - 1) == 0:
            return lanes, MAX_VALUES
    elif 1 <= D <= MAX_VALUES:
        return 1, D
    raise ValueError(f"wkv takes a head size <= 16, or 16 x a power of two up to "
                     f"{MAX_HEAD}, not {D}")


def _launch(fn, state: torch.Tensor, vecs, active, u=None, g=None, beta=None,
            scale: float = 1.0) -> torch.Tensor:
    """Check the operands and launch the kernel of the wrapper ``fn``'s rule,
    counted in ``fn.launches``; vecs are its (B, T, H, D) step vectors in
    the kernel's order."""
    rule = fn.__name__
    dev = vecs[0].device
    if dev.type != "cuda":
        raise ValueError(f"{rule} runs on cuda or cpu tensors, not {dev}")
    kind = _STATE.get(state.dtype)
    if kind is None:
        raise TypeError(f"{rule} takes an f32 or bf16 state, not {state.dtype}")
    Bt, T, H, D = vecs[0].shape
    if (state.shape != (Bt, H, D, D) or any(v.shape != vecs[0].shape for v in vecs)
            or (u is not None and u.shape != (H, D))
            or any(s is not None and s.shape != (Bt, T, H) for s in (g, beta))):
        raise ValueError(f"{rule} shapes: state {tuple(state.shape)}, steps "
                         f"{[tuple(v.shape) for v in vecs]}")
    if not state.is_contiguous():
        raise ValueError(f"{rule} writes its state in place: it must be contiguous")
    lanes, ns = wkv_split(D)
    lib = _build.load("wkv").slt_wkv
    if lib.argtypes is None:
        lib.argtypes = _ARGTYPES
        lib.restype = ctypes.c_int
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()  # noqa: E731
    vecs = [f32(v) for v in vecs]
    u, g, beta = f32(u), f32(g), f32(beta)
    act = None if active is None else active.to(torch.int32).contiguous()
    y = torch.empty((Bt, T, H, D), dtype=torch.float32, device=dev)
    ptrs = [v.data_ptr() for v in vecs] + [None] * (6 - len(vecs))
    err = lib(_RULE[rule], kind, Bt, T, H, D, lanes, ns, float(scale), state.data_ptr(), *ptrs,
              *(None if t is None else t.data_ptr() for t in (u, g, beta, act)), y.data_ptr(),
              _build.stream_ptr(dev))
    _build.check(err, rule)
    fn.launches += 1
    return y


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, u: torch.Tensor, w: torch.Tensor,
         state: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """RWKV-6: y_j = Σ_i r_i (S_ij + u_i k_i v_j); S_ij ← w_i S_ij + k_i v_j.
    r / k / v / w (B, T, H, D), u (H, D); state (B, H, D, D) f32."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, u, w, state, active)
    return _launch(wkv6, state, (r, k, v, w), active, u=u)


def gla(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        state: torch.Tensor, scale: float, active: torch.Tensor | None = None) -> torch.Tensor:
    """Gated linear attention: S_ij ← w_i S_ij + k_i v_j, then y_j = scale ·
    Σ_i r_i S_ij (no bonus)."""
    if r.device.type == "cpu":
        return gla_plain(r, k, v, w, state, scale, active)
    return _launch(gla, state, (r, k, v, w), active, scale=scale)


def wkv7(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, state: torch.Tensor,
         active: torch.Tensor | None = None) -> torch.Tensor:
    """RWKV-7: sa_i = Σ_j a_j S_ij; S_ij ← w_j S_ij + v_i k_j + sa_i b_j;
    y_i = Σ_j S_ij r_j; state (B, H, D, D) [i=val, j=key] f32."""
    if r.device.type == "cpu":
        return wkv7_plain(r, w, k, v, a, b, state, active)
    return _launch(wkv7, state, (r, w, k, v, a, b), active)


def delta_net(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
              beta: torch.Tensor, state: torch.Tensor, eps: float,
              active: torch.Tensor | None = None) -> torch.Tensor:
    """The gated delta rule: q / k l2-normalised (eps), q / √D, σ(β); then
    S ← e^g S; δ = (v − kᵀS)·σ(β); S += k ⊗ δ; y = qᵀS. q / k / v (B, T,
    H, D), g / beta (B, T, H); state (B, H, D, D) f32 or bf16."""
    if q.device.type == "cpu":
        return delta_net_plain(q, k, v, g, beta, state, eps, active)
    qn, kn, b = delta_inputs(q, k, beta, eps)
    return _launch(delta_net, state, (qn, kn, v), active, g=g, beta=b)


for _fn in (wkv6, gla, wkv7, delta_net):
    _fn.launches = 0
