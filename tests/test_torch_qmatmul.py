"""Port parity: quantized weights and matmul (superllama_tpu_torch.ops.qtensor
and .qmatmul) against the JAX package on the same numpy-seeded inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as its own
tests do; the port runs the kernels' plain PyTorch versions (CPU tensors).
Tolerances:
 - repack planes and dequant: bit-exact (same numpy decode, same f32 ops);
 - GEMV vs JAX ``_qmatmul_mv``: NMSE < 1e-10 (the integer group dots are
   exact; only the f32 summation order differs);
 - GEMV vs dequant + f32 matmul: NMSE < 5e-4 (the Q8 activation budget);
 - fused vs JAX ``_qmatmul_2d``: NMSE < 1e-7.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from test_torch_fixtures import cuda_typed, failing_build

from superllama_tpu.gguf import GGMLType, quantize
from superllama_tpu.gguf.constants import GGML_TYPE_TRAITS
from superllama_tpu.ops import qtensor as jqt
from superllama_tpu.ops.qmatmul import _qmatmul_2d, _qmatmul_mv, _quantize_acts
from superllama_tpu_torch.ops import qtensor as tqt
from superllama_tpu_torch.ops.qmatmul import (qmatmul, qmatmul_ref, qmm, qmm_plan, qmv,
                                              quantize_acts)

TYPES = [GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K]
# the (M, K, N) grid of tests/test_backend_ops.py
SHAPES = [(1, 512, 64), (5, 512, 128), (128, 512, 64), (16, 1024, 96),
          (1, 768, 64), (8, 768, 128), (2, 544, 128), (33, 544, 64),
          (47, 1024, 96), (8, 512, 640)]
CASES = [(t, s) for t in TYPES for s in SHAPES
         if s[1] % GGML_TYPE_TRAITS[t].block_size == 0]
MV_CASES = [(t, s) for t, s in CASES if s[0] <= 16]
IDS = lambda c: f"{c[0].name}-{'x'.join(map(str, c[1]))}"


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _weights(ttype, N, K):
    rng = np.random.default_rng(int(ttype) + N + K)
    w = (rng.normal(0, 0.4, (N, K)) + 0.05 * np.cos(np.arange(K))).astype(
        np.float32)
    raw = quantize(w, ttype)
    return raw, jqt.repack(raw, ttype, (N, K)), tqt.repack(raw, ttype, (N, K))


def _x(M, K):
    return np.random.default_rng(M * 7 + K).normal(0, 1, (M, K)).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_repack_and_dequant_bitexact(case):
    ttype, (M, K, N) = case
    _, jq, tq = _weights(ttype, N, K)
    for name in tqt.QTensor.PLANES:
        j, t = getattr(jq, name), getattr(tq, name)
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    for attr in ("group", "offset", "nibble", "K", "N", "hi_bits", "sb"):
        assert getattr(tq, attr) == getattr(jq, attr), attr
    np.testing.assert_array_equal(tqt.dequant_qtensor(tq).numpy(),
                                  np.asarray(jqt.dequant_qtensor(jq)))


@pytest.mark.parametrize("gs", [8, 16, 32, 256])
def test_quantize_acts_matches_jax(gs):
    """Every group size of the formats: IQ1_M's 8, 16, 32, and the 256 of
    Q8_K / TQ1_0 / TQ2_0."""
    x = _x(6, 256) * np.float32(3.0)
    x[0, :gs] = 0.0                                  # an all-zero group
    xq, sx, xs = quantize_acts(torch.from_numpy(x), gs)
    jxq, jsx, jxs = _quantize_acts(jnp.asarray(x), gs)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))


@pytest.mark.parametrize("case", MV_CASES, ids=IDS)
def test_gemv_matches_jax(case):
    ttype, (M, K, N) = case
    _, jq, tq = _weights(ttype, N, K)
    x = _x(M, K)
    xp = np.pad(x, ((0, (-M) % 8), (0, 0)))
    ref = np.asarray(_qmatmul_mv(jnp.asarray(xp), jq, interpret=True))[:M]
    got = qmv(torch.from_numpy(x), tq, torch.float32)
    assert got.shape == (M, N)
    assert _nmse(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("case", MV_CASES, ids=IDS)
def test_gemv_vs_dequant_matmul(case):
    ttype, (M, K, N) = case
    _, _, tq = _weights(ttype, N, K)
    x = torch.from_numpy(_x(M, K))
    got = qmatmul(x, tq, act_quant=True)
    assert _nmse(got.numpy(), qmatmul_ref(x, tq).numpy()) < 5e-4


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_matches_jax(case):
    ttype, (M, K, N) = case
    _, jq, tq = _weights(ttype, N, K)
    x = _x(M, K)
    xp = np.pad(x, ((0, (-M) % 8), (0, 0)))
    ref = np.asarray(_qmatmul_2d(jnp.asarray(xp), jq, interpret=True))[:M]
    got = qmatmul(torch.from_numpy(x), tq, force_fused=True)
    assert got.shape == (M, N)
    assert _nmse(got.numpy(), ref) < 1e-7


def test_fused_bf16_matches_jax():
    ttype, (M, K, N) = GGMLType.Q4_K, (32, 512, 64)
    _, jq, tq = _weights(ttype, N, K)
    x = _x(M, K)
    ref = np.asarray(_qmatmul_2d(jnp.asarray(x, jnp.bfloat16), jq,
                                 interpret=True, out_dtype_name="float32"))
    got = qmm(torch.from_numpy(x).to(torch.bfloat16), tq, torch.float32)
    assert _nmse(got.numpy(), ref) < 1e-7


def test_dispatch_regimes():
    """The three regimes agree with dequant + matmul within their budgets."""
    _, _, tq = _weights(GGMLType.Q4_K, 64, 512)
    for M, kw, tol in ((4, {"act_quant": True}, 5e-4), (24, {}, 1e-10),
                       (40, {}, 1e-10)):
        x = torch.from_numpy(_x(M, 512)).reshape(2, M // 2, 512)
        got = qmatmul(x, tq, **kw)
        assert got.shape == (2, M // 2, 64)
        assert _nmse(got.numpy(), qmatmul_ref(x, tq).numpy()) < tol


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel: when the build fails, qmv and qmm
    raise that failure and never run their plain versions. Every one of the
    23 REPACKABLE types has a kernel layout id (``_check_weight``)."""
    from superllama_tpu_torch.ops import qmatmul as qm_mod

    build_failed = failing_build(monkeypatch)
    _, _, tq = _weights(GGMLType.Q4_K, 64, 512)
    tq = dataclasses.replace(tq, **{n: cuda_typed(p) for n, p in tq.planes().items()})
    for dt in (torch.float32, torch.bfloat16):   # qmm: CUDA-core and tensor-core kernels
        x = cuda_typed(torch.zeros((4, 512), dtype=dt))
        for name in ("qmv", "qmm"):
            fn = getattr(qm_mod, name)
            before = fn.launches
            with pytest.raises(build_failed):
                fn(x, tq, torch.float32)
            assert fn.launches == before
    assert len(tqt.REPACKABLE) == 23
    x = cuda_typed(torch.zeros((1, 256)))
    for ttype in tqt.REPACKABLE:
        _, _, w = _weights(ttype, 64, 256)
        w = dataclasses.replace(w, **{n: cuda_typed(p) for n, p in w.planes().items()})
        assert qm_mod._check_weight(x, w) in range(9), ttype.name


def test_non_cuda_device_raises():
    """A tensor on neither the CPU nor a CUDA device is refused."""
    _, _, tq = _weights(GGMLType.Q8_0, 64, 512)
    x = torch.zeros((1, 512), device="meta")
    with pytest.raises(ValueError):
        qmv(x, tq, torch.float32)
    with pytest.raises(ValueError):
        qmm(x, tq, torch.float32)


# (K, N) of a lone prompt chunk's matmuls at Llama-3-8B width: wq/wo, wk/wv,
# ffn gate/up, ffn down, the output head
KN_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("K,N", KN_8B + [(512, 64), (544, 128), (768, 96), (1024, 640)])
def test_qmm_plan_covers_every_k_tile_once(K, N):
    """The tensor-core qmm kernel's splits take k-tiles of 128 (a Q8_0 K's
    last one shorter): every tile belongs to exactly one split and no split
    is empty."""
    n_split, per = qmm_plan(K, N)
    n_tiles = -(-K // 128)
    seen = np.zeros(n_tiles, np.int64)
    for sp in range(n_split):
        tiles = range(sp * per, min((sp + 1) * per, n_tiles))
        assert len(tiles) >= 1
        seen[tiles.start:tiles.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("K,N", KN_8B)
def test_qmm_plan_fills_the_card(K, N):
    """At every shape of a lone chunk the grid gives all but at most 4 of
    the H100's 132 SMs a block (the head's 1,002 column blocks need no
    split): one block a SM where that leaves each block at most 16 k-tiles
    (the largest such split), else no other split within one resident wave
    (264 blocks, two an SM) takes fewer rounds of k-tiles."""
    n_split, per = qmm_plan(K, N)
    n_col, n_tiles = -(-N // 128), -(-K // 128)
    assert n_col * n_split >= 128
    assert (n_split == 1) == (N == 128256)
    if n_col * n_split <= 132:
        assert per <= 16 and n_col * (n_split + 1) > 132
        return

    def rounds(sp):
        p = -(-n_tiles // sp)
        return -(-n_col * -(-n_tiles // p) // 264) * p

    assert -(-n_col * n_split // 264) * per == min(
        rounds(sp) for sp in range(1, min(n_tiles, -(-264 // n_col)) + 1))


def test_qmm_plan_is_a_function_of_k_and_n():
    """The plan takes no row count, so a row's sums are the same in a 17- and
    a 32-row call; it is the same for every format at one (K, N)."""
    import inspect

    assert list(inspect.signature(qmm_plan).parameters) == ["K", "N"]
    assert qmm_plan(4096, 14336) == (2, 16)
