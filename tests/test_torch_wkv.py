"""Port parity of the linear-attention recurrences (superllama_tpu_torch/ops/wkv.py,
ops/ref.py) against the JAX package, on the CPU:

 - each plain recurrence (wkv6 with its bonus, gla with its scale, wkv7, the
   gated delta net with its l2 norms, 1/√D and σ(β)) against the JAX
   function (``superllama_tpu/models/rwkv.py::wkv6 / gla / wkv7``,
   ``models/qwen3next.py::delta_net``) at T 1 and 9, D 8 and 16, in the
   JAX state layouts: y and the final state;
 - the delta net's bf16 state round trip (one rounding of the f32 state, as
   the JAX layer casts it back);
 - idle rows keeping their state (y 0 there), the others unchanged;
 - ``wkv_split`` (lanes and values a lane) and its refusals;
 - each wrapper's launch on CUDA-typed tensors through a recording stand-in
   for the library (one call, its arguments), its refusals, a failed build
   raising, and the plain route launching nothing.

Tolerances: y and the f32 state 1e-5 (rtol and atol; the sums run in
another order than the JAX einsums'); the bf16 state within one bf16 ulp.
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from superllama_tpu.models import qwen3next as jq3n
from superllama_tpu.models import rwkv as jrwkv
from superllama_tpu_torch.ops import _build
from superllama_tpu_torch.ops import wkv
from test_torch_fixtures import cuda_typed, failing_build

TOL = dict(rtol=1e-5, atol=1e-5)
EPS = 1e-6
GLA_SCALE = 0.25
RULES = ("wkv6", "gla", "wkv7", "delta_net")


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(rule: str, B: int, T: int, D: int, H: int = 2, seed: int = 0) -> dict:
    """Seeded step inputs in the ranges the models give them: decays in
    (0, 1), wkv7's a = −kk and b = kk·a' (kk l2-normed, a' in (0, 1)), the
    delta net's log-decay below 0; and a state of (B, H, D, D)."""
    rng = np.random.default_rng([seed, B, T, D, RULES.index(rule)])
    x = lambda s=1.0: _f(rng, B, T, H, D, scale=s)             # noqa: E731
    out = {"state": _f(rng, B, H, D, D, scale=0.3)}
    if rule in ("wkv6", "gla"):
        out.update(r=x(), k=x(0.5), v=x(), w=np.exp(-np.exp(x(0.5))).astype(np.float32))
        if rule == "wkv6":
            out["u"] = _f(rng, H, D)
    elif rule == "wkv7":
        kk = x()
        kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
        a = 1 / (1 + np.exp(-x()))
        out.update(r=x(), w=np.exp(-0.606531 / (1 + np.exp(-x()))).astype(np.float32),
                   k=x(0.5), v=x(), a=-kk, b=(kk * a).astype(np.float32))
    else:
        out.update(q=x(), k=x(), v=x(), g=-np.log1p(np.exp(_f(rng, B, T, H))),
                   beta=_f(rng, B, T, H))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


# argument order of each function after the state-free step inputs
_ORDER = {"wkv6": ("r", "k", "v", "u", "w"), "gla": ("r", "k", "v", "w"),
          "wkv7": ("r", "w", "k", "v", "a", "b"), "delta_net": ("q", "k", "v", "g", "beta")}


def _jax(rule: str, inp: dict):
    """(y, state) of the JAX function, jitted."""
    args = [jnp.asarray(inp[k]) for k in _ORDER[rule]] + [jnp.asarray(inp["state"])]
    fn = {"wkv6": jrwkv.wkv6, "wkv7": jrwkv.wkv7,
          "gla": lambda *a: jrwkv.gla(*a, GLA_SCALE),
          "delta_net": lambda *a: jq3n.delta_net(*a, EPS)}[rule]
    y, st = jax.jit(fn)(*args)
    return np.asarray(y), np.asarray(st)


def _port(rule: str, inp: dict, state: torch.Tensor, active=None) -> torch.Tensor:
    args = [t if isinstance(t, torch.Tensor) else torch.from_numpy(t)
            for t in (inp[k] for k in _ORDER[rule])]
    fn = getattr(wkv, rule)
    extra = {"gla": (GLA_SCALE,), "delta_net": (EPS,)}.get(rule, ())
    return fn(*args, state, *extra, active)


@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("rule", RULES)
def test_plain_matches_jax(rule, T, D):
    inp = _inputs(rule, 2, T, D)
    y_ref, st_ref = _jax(rule, inp)
    state = torch.from_numpy(inp["state"].copy())
    y = _port(rule, inp, state)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    np.testing.assert_allclose(state.numpy(), st_ref, **TOL)


@pytest.mark.parametrize("T", [1, 9])
def test_delta_net_bf16_state_round_trip(T):
    """A bf16 state: read as f32, run, written back with one rounding (the
    JAX layer's ``.astype(ssm_state.dtype)``)."""
    inp = _inputs("delta_net", 2, T, 16)
    inp["state"] = np.asarray(torch.from_numpy(inp["state"]).to(torch.bfloat16).float())
    y_ref, st_ref = _jax("delta_net", inp)
    state = torch.from_numpy(inp["state"]).to(torch.bfloat16)
    y = _port("delta_net", inp, state)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    want = torch.from_numpy(st_ref.copy()).to(torch.bfloat16).float()
    np.testing.assert_allclose(state.float().numpy(), want.numpy(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("rule", RULES)
def test_plain_keeps_idle_rows(rule):
    inp = _inputs(rule, 3, 5, 16)
    active = torch.tensor([True, False, True])
    full = torch.from_numpy(inp["state"].copy())
    y_all = _port(rule, inp, full)
    state = torch.from_numpy(inp["state"].copy())
    y = _port(rule, inp, state, active)
    np.testing.assert_array_equal(state[1].numpy(), inp["state"][1])
    assert not y[1].any()
    np.testing.assert_array_equal(state[[0, 2]].numpy(), full[[0, 2]].numpy())
    np.testing.assert_array_equal(y[[0, 2]].numpy(), y_all[[0, 2]].numpy())


@pytest.mark.parametrize("D,split", [(8, (1, 8)), (16, (1, 16)), (32, (2, 16)),
                                     (64, (4, 16)), (128, (8, 16))])
def test_wkv_split(D, split):
    assert wkv.wkv_split(D) == split


@pytest.mark.parametrize("D", [24, 48, 256])
def test_wkv_split_refuses(D):
    with pytest.raises(ValueError, match="head size"):
        wkv.wkv_split(D)


@pytest.fixture
def recorded(monkeypatch):
    """CUDA-typed tensors reach a recording stand-in for slt_wkv; torch.empty
    keeps them CUDA-typed; the plain versions raise."""
    calls = []

    def slt_wkv(*args):
        calls.append(args)
        return 0
    slt_wkv.argtypes = None
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(slt_wkv=slt_wkv))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 7)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: cuda_typed(
        empty(*a, **{k: v for k, v in kw.items() if k != "device"})))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    for name in ("wkv6_plain", "gla_plain", "wkv7_plain", "delta_net_plain"):
        monkeypatch.setattr(wkv, name, plain)
    return calls


def _cuda_inputs(rule, D=64, dtype=torch.float32):
    inp = {k: cuda_typed(torch.from_numpy(v)) for k, v in _inputs(rule, 2, 3, D).items()}
    inp["state"] = cuda_typed(inp["state"].to(dtype))
    return inp


@pytest.mark.parametrize("rule,D,dtype,active", [
    ("wkv6", 64, torch.float32, False), ("gla", 128, torch.float32, True),
    ("wkv7", 64, torch.float32, True), ("delta_net", 128, torch.bfloat16, True),
    ("delta_net", 16, torch.float32, False)])
def test_wrapper_launches_the_kernel_once(recorded, rule, D, dtype, active):
    inp = _cuda_inputs(rule, D, dtype)
    act = cuda_typed(torch.tensor([True, False])) if active else None
    fn = getattr(wkv, rule)
    before = fn.launches
    y = _port(rule, inp, inp["state"], act)
    assert fn.launches == before + 1
    assert y.device.type == "cuda" and tuple(y.shape) == (2, 3, 2, D)
    assert y.dtype == torch.float32
    (c,) = recorded
    lanes, ns = wkv.wkv_split(D)
    assert c[:8] == (wkv._RULE[rule], int(dtype == torch.bfloat16), 2, 3, 2, D, lanes, ns)
    assert c[8] == pytest.approx(GLA_SCALE if rule == "gla" else 1.0)
    assert c[9] == inp["state"].data_ptr()
    n_vec = {"wkv7": 6, "delta_net": 3}.get(rule, 4)
    assert all(p is not None for p in c[10:10 + n_vec])
    assert all(p is None for p in c[10 + n_vec:16])
    assert (c[16] is None) == (rule != "wkv6")                     # u
    assert (c[17] is None) == (c[18] is None) == (rule != "delta_net")
    assert (c[19] is None) == (not active)
    assert c[-1] == 7


def test_wrapper_refusals(recorded):
    inp = _cuda_inputs("wkv6")
    args = [inp[k] for k in _ORDER["wkv6"]]
    with pytest.raises(TypeError, match="f32 or bf16 state"):
        wkv.wkv6(*args, cuda_typed(inp["state"].to(torch.float16)))
    with pytest.raises(ValueError, match="shapes"):
        wkv.wkv6(*args, cuda_typed(inp["state"][:, :1].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        wkv.wkv6(*args, cuda_typed(inp["state"].transpose(2, 3).contiguous().transpose(2, 3)))
    bad = _cuda_inputs("wkv7", D=48)
    with pytest.raises(ValueError, match="head size"):
        wkv.wkv7(*[bad[k] for k in _ORDER["wkv7"]], bad["state"])
    assert not recorded


def test_wrapper_refuses_other_devices():
    inp = {k: torch.from_numpy(v).to("meta") for k, v in _inputs("gla", 2, 2, 16).items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        wkv.gla(*[inp[k] for k in _ORDER["gla"]], inp["state"], GLA_SCALE)


@pytest.mark.parametrize("rule", RULES)
def test_failed_build_raises(monkeypatch, rule):
    err = failing_build(monkeypatch)
    inp = _cuda_inputs(rule)
    with pytest.raises(err):
        _port(rule, inp, inp["state"])


@pytest.mark.parametrize("rule", RULES)
def test_plain_route_launches_nothing(rule):
    fn = getattr(wkv, rule)
    before = fn.launches
    inp = _inputs(rule, 2, 2, 16)
    _port(rule, inp, torch.from_numpy(inp["state"]))
    assert fn.launches == before


def test_graph_replays_count_every_rule():
    """A replayed block or chunk adds its capture's wkv launches too."""
    from superllama_tpu_torch.runtime.graphs import launch_counters

    have = {(fn, attr) for fn, attr in launch_counters()}
    assert all((getattr(wkv, rule), "launches") in have for rule in RULES)
