"""Selective scan: the state recurrence of the Mamba-1, Mamba-2 and PLaMo-2
mixers.

Counterpart of the ``jax.lax.scan`` of the JAX package's mixers
(``superllama_tpu/models/mamba.py:73`` mamba1, ``:134`` mamba2, ``:197``
plamo2), in one form: the state (B, nh, hd, ds), a decay A per (head,
state) (mamba1, nh = d_inner, hd = 1) or per head, B / C in G groups,

    st = st * exp(dt * A) + (dt * x) * B;   y = st · C   (f32)

On CUDA tensors ``ssm_scan`` launches the hand-written kernel of
``csrc/ssm_scan.cu``, counted in ``ssm_scan.launches``; on CPU tensors it
runs ``ops/ref.py::ssm_scan_plain``. The state is written in place, and a
row whose ``active`` flag is False keeps it (y 0 there): the JAX engine's
``mask_rows``, done inside the step. Nothing is read on the host, so a CUDA
graph captures the call.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssm_scan_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I] * 11 + [_P] * 9
_STATE = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATES = 16          # states a thread holds


def scan_split(ds: int) -> tuple[int, int]:
    """(lanes, states a lane) of a state row of ds: 16 a lane where ds is a
    multiple of 16 (lanes a power of two up to 32), else one lane of ds ≤ 16."""
    if ds % MAX_STATES == 0:
        lanes = ds // MAX_STATES
        if lanes <= 32 and lanes & (lanes - 1) == 0:
            return lanes, MAX_STATES
    elif 1 <= ds <= MAX_STATES:
        return 1, ds
    raise ValueError(f"ssm_scan takes d_state <= 16, or 16 x a power of two up to 512, "
                     f"not {ds}")


def ssm_scan(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             active: torch.Tensor | None = None) -> torch.Tensor:
    """state (B, nh, hd, ds) f32 or bf16, contiguous, updated in place; x
    (B, T, nh, hd), dt (B, T, nh), A (nh, ds) or (nh,), Bm / Cm (B, T, G,
    ds), f32; active (B,) bool or None (every row). Returns y (B, T, nh,
    hd) f32."""
    if x.device.type == "cpu":
        return ssm_scan_plain(state, x, dt, A, Bm, Cm, active)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu tensors, not {x.device}")
    kind = _STATE.get(state.dtype)
    if kind is None:
        raise TypeError(f"ssm_scan takes an f32 or bf16 state, not {state.dtype}")
    Bt, T, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    if (state.shape != (Bt, nh, hd, ds) or dt.shape != (Bt, T, nh) or Bm.shape != (Bt, T, G, ds)
            or Cm.shape != Bm.shape or A.shape not in ((nh, ds), (nh,)) or nh % G):
        raise ValueError(f"ssm_scan shapes: state {tuple(state.shape)}, x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}")
    if not state.is_contiguous():
        raise ValueError("ssm_scan writes its state in place: it must be contiguous")
    lanes, ns = scan_split(ds)
    fn = _build.load("ssm_scan").slt_ssm_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    x, dt, A, Bm, Cm = (t.to(torch.float32).contiguous() for t in (x, dt, A, Bm, Cm))
    act = None if active is None else active.to(torch.int32).contiguous()
    y = torch.empty((Bt, T, nh, hd), dtype=torch.float32, device=x.device)
    vec = int(ns == MAX_STATES and all(t.data_ptr() % 16 == 0
                                       for t in (state, A, Bm, Cm)))
    err = fn(Bt, T, nh, hd, ds, G, lanes, ns, int(A.ndim == 2), kind, vec, state.data_ptr(),
             x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if act is None else act.data_ptr(), y.data_ptr(),
             _build.stream_ptr(x.device))
    _build.check(err, "ssm_scan")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
