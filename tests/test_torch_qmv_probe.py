"""Port parity: the GEMV-variant probe (superllama_tpu_torch.tools.qmv_probe)
against the JAX package's ``tools/qmv_probe.qmv_variant`` on the same
numpy-seeded Q4_K planes and activations.

The JAX side runs its Pallas kernels in interpret mode on the CPU: its
``qmv_variant`` passes no ``interpret``, so the test patches the module's
``pl.pallas_call`` to interpret. The port runs the kernels' plain PyTorch
versions (CPU tensors). Tolerances:
 - against JAX and against the port's ``qmv``: NMSE < 1e-10 (the integer
   group dots are exact and both quantize x bit-alike; only the f32
   summation order differs);
 - against ``qmatmul_ref`` (dequant + f32 matmul): NMSE < 1e-4, the probe's
   own gate (int8 activations).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from test_torch_fixtures import cuda_typed, failing_build

from superllama_tpu.gguf.constants import GGMLType
from superllama_tpu.ops.qtensor import QTensor as JaxQTensor
from superllama_tpu.tools import qmv_probe as jprobe
from superllama_tpu_torch.convert import _qtensor
from superllama_tpu_torch.ops.qmatmul import qmatmul_ref, qmv
from superllama_tpu_torch.ops.qtensor import QTensor
from superllama_tpu_torch.tools import qmv_probe as tprobe

VARIANTS = ["v1", "v2", "v3", "v4"]
SHAPES = [(1, 1024, 512), (3, 2048, 640), (8, 2048, 512), (16, 1024, 1536)]
CASES = [(v, s) for v in VARIANTS for s in SHAPES]
IDS = lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}"


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _weights(N, K):
    """One Q4_K weight in the compact layout, as a JAX and a port QTensor:
    uniform nibbles, sub-scales/mins in [24, 41), f32 d and dmin."""
    rng = np.random.default_rng(N * 3 + K)
    planes = dict(
        sc=rng.integers(24, 41, (K // 32, N), dtype=np.uint8),
        mn=rng.integers(24, 41, (K // 32, N), dtype=np.uint8),
        d=(rng.random((K // 256, N)) * 2e-3 + 1e-4).astype(np.float32),
        dmin=(rng.random((K // 256, N)) * 1.5e-2 + 1e-4).astype(np.float32))
    codes = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    jq = JaxQTensor(jnp.asarray(codes), None, None, 32, 0, True, K, N, GGMLType.Q4_K,
                    sb=8, **{k: jnp.asarray(v) for k, v in planes.items()})
    return jq, _qtensor(jq, "cpu")


def _x(M, K):
    return np.random.default_rng(M * 7 + K).normal(0, 1, (M, K)).astype(np.float32)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX probe's pallas_call in interpret mode, for this test only."""
    monkeypatch.setattr(jprobe.pl, "pallas_call",
                        functools.partial(jprobe.pl.pallas_call, interpret=True))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_variant_matches_jax(case, jax_interpret):
    variant, (M, K, N) = case
    jq, tq = _weights(N, K)
    x = _x(M, K)
    ref = np.asarray(jprobe.qmv_variant(jnp.asarray(x), jq, variant))
    xt = torch.from_numpy(x)
    got = tprobe.qmv_variant(xt, tq, variant)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert _nmse(got.numpy(), ref) < 1e-10
    assert _nmse(got.numpy(), qmv(xt, tq, torch.float32).numpy()) < 1e-10
    assert _nmse(got.numpy(), qmatmul_ref(xt, tq).numpy()) < 1e-4


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_prep_matches_jax(variant):
    """The activation layouts: (G, M, 32) codes (v2: lo/hi halves) and the
    (M, G) scales and group sums, (K/1024, M, 32) for v3."""
    M, K = 5, 2048
    x = _x(M, K) * np.float32(3.0)
    (jxg, *jrest), jsx, jxs = jprobe._prep(jnp.asarray(x), split_lohi=variant == "v2")
    got = [t.numpy() for t in tprobe.prep_acts(torch.from_numpy(x), variant)]
    want = [np.asarray(jxg), *map(np.asarray, jrest)]
    jsx, jxs = np.asarray(jsx), np.asarray(jxs)
    if variant == "v3":
        chunk = lambda a: a.reshape(M, K // 1024, 32).transpose(1, 0, 2)
        want += [chunk(jsx), chunk(jxs)]
    else:
        want += [jsx, jxs]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _q8_weight(N, K):
    return QTensor(torch.zeros((K, N), dtype=torch.int8), torch.ones((K // 32, N)), None,
                   32, 0, False, K, N, GGMLType.Q8_0)


@pytest.mark.parametrize("bad", ["q8_0 weight", "v3 K=1536", "unknown variant"])
def test_refuses(bad):
    M, K, N = 2, 1536 if bad == "v3 K=1536" else 1024, 64
    _, tq = _weights(N, K)
    variant = {"unknown variant": "v5", "v3 K=1536": "v3"}.get(bad, "v1")
    if bad == "q8_0 weight":
        tq = _q8_weight(N, K)
    x = torch.from_numpy(_x(M, K))
    with pytest.raises(ValueError):
        tprobe.qmv_variant(x, tq, variant)
    with pytest.raises(ValueError):
        tprobe.qmv_variant_plain(x, tq, variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_tensor_never_takes_plain_path(monkeypatch, variant):
    """A CUDA tensor goes to the kernel: when the build fails, the wrapper
    raises that failure and never runs the plain version."""
    build_failed = failing_build(monkeypatch)
    _, tq = _weights(64, 1024)
    tq = dataclasses.replace(tq, **{n: cuda_typed(p) for n, p in tq.planes().items()})
    x = cuda_typed(torch.zeros((4, 1024)))
    before = dict(tprobe.qmv_variant.launches)
    with pytest.raises(build_failed):
        tprobe.qmv_variant(x, tq, variant)
    assert tprobe.qmv_variant.launches == before


def test_non_cuda_device_raises():
    """A tensor on neither the CPU nor a CUDA device is refused."""
    _, tq = _weights(64, 1024)
    with pytest.raises(ValueError):
        tprobe.qmv_variant(torch.zeros((1, 1024), device="meta"), tq, "v1")


def test_cuda_launch_takes_at_most_16_rows(monkeypatch):
    """The kernels are instantiated for up to 16 rows: more are refused
    before any build or launch."""
    failing_build(monkeypatch)
    _, tq = _weights(64, 1024)
    tq = dataclasses.replace(tq, **{n: cuda_typed(p) for n, p in tq.planes().items()})
    with pytest.raises(ValueError):
        tprobe.qmv_variant(cuda_typed(torch.zeros((17, 1024))), tq, "v1")
