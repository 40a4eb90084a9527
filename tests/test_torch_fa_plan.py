"""The prefill kernel's route and geometry (superllama_tpu_torch.ops
.flash_attention.fa_plan) and the port's flash_attention against the JAX
package's on the inputs the tensor-core kernel was redesigned for, on the
CPU.

The plan is what csrc/fa.cu is launched with (the kernel refuses a launch
whose slots a tile, row tiles or shared-memory bytes differ from its own
layout), so these tests hold it to the kernel's contract:
 - bf16 q over bf16 or Q8_0 K/V takes the tensor-core kernel at every head
   size up to 256 (D 128, the main path's, with 64-slot tiles), D and Dv
   padded to whole 16s, tiles a whole number of 16 slots, within the
   H100's 232,448 bytes of shared memory a block, and two blocks an SM at
   D 128;
 - f32 q, or bf16 q over f32 K/V (an f32 cache), takes the CUDA-core
   kernel, where the JAX package runs QK^T or P.V in f32;
 - a block holds 64 query rows of one kv head's G heads, and the grid's
   row tiles cover every token when T*G is not a multiple of 64.
A CUDA tensor reaches the kernel its plan names (here its failing build),
never a plain version.

Parity: the port's flash_attention (its plain version on the CPU) against
the JAX kernel in interpret mode, compiled without XLA's excess precision
(xla_exact), on numpy-seeded inputs. Only rows with q_pos >= 0 are
compared. Tolerances: NMSE < 1e-9 in f32 (same logits, summation order
differs); < 2e-5 where p or V round to bf16 (a rounding boundary can fall
either way).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.ops.flash_attention import flash_attention as jax_fa
from superllama_tpu_torch.ops.flash_attention import (FA_ROWS, SMEM_MAX, fa_plan,
                                                      flash_attention)
from test_torch_fixtures import cuda_typed, failing_build, xla_exact

HEAD_SIZES = (16, 32, 64, 80, 96, 100, 128, 192, 256)
SM_SMEM = 233472   # shared memory of one H100 SM; 1 KB a block is reserved


def _plan(T=32, S=2048, H=32, Hkv=8, D=128, Dv=None, q=torch.bfloat16, kv=torch.bfloat16):
    qt = torch.zeros((1, T, H, D), dtype=q)
    k = torch.zeros((1, Hkv, S, D), dtype=kv)
    v = torch.zeros((1, Hkv, S, Dv or D), dtype=kv)
    return fa_plan(qt, k, v)


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("D", HEAD_SIZES)
def test_bf16_q_takes_the_tensor_cores(D, kv):
    """Every head size on the tensor cores: whole 16s, the shared memory a
    block may take, 64-slot tiles up to 128 columns (32 above), and a grid
    whose row tiles cover T 37 (T*G 148, not a multiple of 64)."""
    p = _plan(T=37, D=D, kv=kv)
    assert p.kernel == "tc"
    assert p.smem <= SMEM_MAX
    assert p.bs % 16 == 0 and p.dk % 16 == 0 and p.dv % 16 == 0
    assert D <= p.dk < D + 16 and D <= p.dv < D + 16
    assert p.bs == (64 if D <= 128 else 32)
    assert p.rows == FA_ROWS and p.bt * 4 <= FA_ROWS
    assert (p.grid[0] - 1) * p.bt < 37 <= p.grid[0] * p.bt
    assert p.grid[1:] == (8, 1)
    if D <= 128:   # two blocks an SM (four warps each)
        assert 2 * (p.smem + 1024) <= SM_SMEM


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("q,kv", [(torch.float32, torch.float32),
                                  (torch.float32, torch.bfloat16),
                                  (torch.bfloat16, torch.float32)],
                         ids=["f32 q f32 kv", "f32 q bf16 kv", "bf16 q f32 kv"])
def test_f32_products_take_the_cuda_cores(D, q, kv):
    """f32 q (QK^T in f32) or f32 V (P.V in f32): the CUDA-core kernel,
    its Dv padded to the next instantiated width, within the shared memory
    a block may take."""
    p = _plan(D=D, q=q, kv=kv)
    assert p.kernel == "cc"
    assert p.dv >= D and p.dv in (16, 32, 64, 96, 128, 192, 256)
    assert p.smem <= SMEM_MAX


def test_f32_q_over_q8_0_takes_the_cuda_cores():
    assert _plan(q=torch.float32, kv=torch.int8).kernel == "cc"


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("S", [256, 2048, 32768, 131072])
def test_long_caches_fit(S, kv):
    """The visible-tile list grows with the cache (4 bytes a tile); the
    rest of a block's shared memory does not."""
    p, base = _plan(S=S, kv=kv), _plan(S=64, kv=kv)
    assert p.smem - base.smem == -(-4 * -(-S // p.bs) // 16) * 16 - 16
    assert p.smem <= SMEM_MAX


@pytest.mark.parametrize("G", [1, 3, 4, 8, 48, 64])
@pytest.mark.parametrize("T", [1, 37, 1024])
def test_row_tiles_cover_every_token(G, T):
    """64 // G tokens a block (rows (t, g) of one kv head, at most 64), as
    many row tiles as cover T."""
    p = _plan(T=T, H=2 * G, Hkv=2)
    assert p.bt == FA_ROWS // G and p.bt * G <= FA_ROWS
    assert (p.grid[0] - 1) * p.bt < T <= p.grid[0] * p.bt


def _args(q, k, v, q_pos, kv_pos, sinks=None, ks=None, vs=None):
    args = [cuda_typed(torch.from_numpy(a)) for a in (q, k, v, q_pos, kv_pos)]
    kw = {}
    if sinks is not None:
        kw["sinks"] = cuda_typed(torch.from_numpy(sinks))
    if ks is not None:
        kw["k_scale"], kw["v_scale"] = (cuda_typed(torch.from_numpy(ks)),
                                        cuda_typed(torch.from_numpy(vs)))
    return args, kw


@pytest.mark.parametrize("kind", ["bf16", "q8_0", "f32"])
def test_cuda_tensor_reaches_its_kernel(monkeypatch, kind):
    """A CUDA tensor goes to the kernel fa_plan names: when its build fails
    the wrapper raises that failure, runs no plain version and counts no
    launch of either kernel."""
    build_failed = failing_build(monkeypatch)
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (1, 40, 8, 128)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, 64, 128)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None]
    kv_pos = np.arange(64, dtype=np.int32)[None]
    ks = vs = None
    if kind == "q8_0":
        ks = vs = np.ones((1, 2, 64), np.float32)
        k = np.round(k).astype(np.int8)
    args, kw = _args(q, k, k, pos, kv_pos, ks=ks, vs=vs)
    if kind != "f32":
        args[0] = cuda_typed(args[0].to(torch.bfloat16))
    if kind == "bf16":
        args[1] = args[2] = cuda_typed(args[1].to(torch.bfloat16))
    assert fa_plan(*args[:3]).kernel == ("cc" if kind == "f32" else "tc")
    before = (flash_attention.launches, flash_attention.launches_tc)
    with pytest.raises(build_failed):
        flash_attention(*args, **kw)
    assert (flash_attention.launches, flash_attention.launches_tc) == before


# ------------------------------------------------------------------ parity


def _inputs(B, T, S, G, D, lens, n_past, seed, Hkv=2, scramble=False, sinks=False,
            q8=False):
    """Slots [0, n_past + len) of each row hold positions in order, the rest
    are empty; query rows at n_past .. n_past + len - 1, padding rows -1.
    ``scramble``: each row's positions scattered over all S slots in no
    order, one in eight dropped (-1), as after seq_rm or a slot copy."""
    H = Hkv * G
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    q_pos = np.full((B, T), -1, np.int32)
    kv_pos = np.full((B, S), -1, np.int32)
    for b, n in enumerate(lens):
        q_pos[b, :n] = np.arange(n_past, n_past + n)
        kv_pos[b, :n_past + n] = np.arange(n_past + n)
        if scramble:
            kv_pos[b] = kv_pos[b, rng.permutation(S)]
            kv_pos[b, rng.permutation(S)[:S // 8]] = -1
    out = {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_pos": kv_pos,
           "sinks": rng.normal(0, 1, (H,)).astype(np.float32) if sinks else None}
    if q8:
        ks = np.abs(k).max(-1) / np.float32(127.0)
        vs = np.abs(v).max(-1) / np.float32(127.0)
        out["k"] = np.round(k / ks[..., None]).astype(np.int8)
        out["v"] = np.round(v / vs[..., None]).astype(np.int8)
        out["k_scale"], out["v_scale"] = ks, vs
    return out


def _run_both(inp, bf16=False, swa=0, softcap=0.0):
    """(port, JAX) outputs as f32 numpy; bf16: q (and float K/V) in bf16."""
    names = ("q", "k", "v", "q_pos", "kv_pos", "sinks", "k_scale", "v_scale")
    vals = [inp.get(n) for n in names]
    if bf16:
        vals[0] = vals[0].astype(jnp.bfloat16)
        if vals[1].dtype == np.float32:
            vals[1], vals[2] = vals[1].astype(jnp.bfloat16), vals[2].astype(jnp.bfloat16)
    present = [i for i, a in enumerate(vals) if a is not None]

    def jax_call(*arrs):
        kw = dict(zip((names[i] for i in present), arrs))
        return jax_fa(kw.pop("q"), kw.pop("k"), kw.pop("v"), kw.pop("q_pos"), kw.pop("kv_pos"),
                      swa_window=swa, logit_softcap=softcap, interpret=True, **kw)

    ref = xla_exact(jax_call, *(jnp.asarray(vals[i]) for i in present))

    def to_torch(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(a))

    tt = {names[i]: to_torch(vals[i]) for i in present}
    got = flash_attention(tt.pop("q"), tt.pop("k"), tt.pop("v"), tt.pop("q_pos"),
                          tt.pop("kv_pos"), swa_window=swa, logit_softcap=softcap, **tt)
    return np.asarray(got.to(torch.float32)), np.asarray(ref, np.float32)


def _nmse(got, ref) -> float:
    g, r = got.astype(np.float64), ref.astype(np.float64)
    return float(np.mean((g - r) ** 2) / np.mean(r ** 2))


# (name, _inputs kwargs, bf16, swa, softcap): the tensor-core kernel's cells
# at tiny widths
CELLS = [
    ("T256 S512 G4 D32 mixed lengths", dict(B=2, T=256, S=512, G=4, D=32, lens=[256, 77],
                                            n_past=0), False, 0, 0.0),
    ("T256 S512 G4 D32 mixed lengths bf16", dict(B=2, T=256, S=512, G=4, D=32,
                                                 lens=[256, 77], n_past=0), True, 0, 0.0),
    ("scrambled kv_pos", dict(B=2, T=64, S=384, G=4, D=32, lens=[64, 40], n_past=200,
                              scramble=True), False, 0, 0.0),
    ("scrambled kv_pos swa", dict(B=2, T=64, S=384, G=4, D=32, lens=[64, 40], n_past=200,
                                  scramble=True), False, 100, 0.0),
    ("scrambled kv_pos swa bf16", dict(B=2, T=64, S=384, G=4, D=32, lens=[64, 40],
                                       n_past=200, scramble=True), True, 100, 0.0),
    ("q8_0 kv bf16 q T128", dict(B=2, T=128, S=256, G=4, D=32, lens=[128, 50], n_past=100,
                                 q8=True), True, 0, 0.0),
    ("sinks softcap", dict(B=2, T=64, S=256, G=4, D=32, lens=[64, 64], n_past=150,
                           sinks=True), False, 0, 30.0),
    ("sinks softcap bf16", dict(B=2, T=64, S=256, G=4, D=32, lens=[64, 64], n_past=150,
                                sinks=True), True, 0, 30.0),
    ("D256 bf16", dict(B=1, T=48, S=128, G=2, D=256, lens=[48], n_past=60), True, 0, 0.0),
    ("padding-only row tiles", dict(B=2, T=128, S=256, G=4, D=32, lens=[5, 128],
                                    n_past=30), False, 0, 0.0),
]


@pytest.mark.parametrize("name,kw,bf16,swa,softcap", CELLS, ids=[c[0] for c in CELLS])
def test_flash_attention_matches_jax(name, kw, bf16, swa, softcap):
    inp = _inputs(seed=len(name), **kw)
    got, ref = _run_both(inp, bf16, swa, softcap)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    valid = inp["q_pos"] >= 0
    rounded = bf16 or kw.get("q8", False)
    assert _nmse(got[valid], ref[valid]) < (2e-5 if rounded else 1e-9)
