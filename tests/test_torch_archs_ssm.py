"""Port parity of the eight state-space names (mamba, mamba2, jamba,
granitehybrid, nemotron_h, nemotron_h_moe, falcon-h1, plamo2): each one's
tiny GGUF (tests/test_torch_fixtures.py::arch_spec: ``ssm_spec``, or
ref_arch_specs' tensor sets for nemotron_h_moe and plamo2) through both
packages' Context on the recurrent or hybrid memory, a 12-token prefill and
two decode steps, f32 weights, logits to ARCH_TOL; and the mamba spec
written in Q4_K and loaded packed (``keep_quantized=True``), so the
``qmm`` / ``qmv`` plain paths see the SSM projections (``ssm_in``,
``ssm_x``, ``ssm_out``; ``ssm_dt``'s 16 rows stay dense, as the JAX loader
leaves them)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from superllama_tpu.gguf import GGMLType
from superllama_tpu_torch.ops.qtensor import QTensor
from test_torch_fixtures import (ARCH_TOL, SSM_REGISTERED, arch_models, dense_logits,
                                 torch_one_thread)  # noqa: F401


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    return tmp_path_factory.mktemp("ssm_archs")


@pytest.fixture(scope="module")
def models(d):
    """(JAX model, port model) of each name's f32 file, loaded once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = arch_models(d, arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", SSM_REGISTERED)
def test_ssm_arch_matches_jax(models, arch, torch_one_thread):
    jm, tm = models(arch)
    got, ref = dense_logits(jm, tm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)


def test_mamba_q4_k_packed_matches_jax(d, torch_one_thread):
    jm, tm = arch_models(d, "mamba", GGMLType.Q4_K, keep_quantized=True)
    layer = tm.params["layers"][0]
    assert all(isinstance(layer[k], QTensor) for k in ("ssm_in", "ssm_x", "ssm_out"))
    assert not isinstance(layer["ssm_dt"], QTensor)
    got, ref = dense_logits(jm, tm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)


@pytest.mark.parametrize("arch", ["jamba", "plamo2"])
def test_params_from_jax_carry_the_ssm_layers(models, arch):
    """``params_from_jax`` of the JAX loader's tree equals the port's own
    load: every SSM, attention, FFN and expert tensor, by name."""
    import jax
    import torch

    from superllama_tpu_torch.convert import params_from_jax

    jm, tm = models(arch)
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), tm.hparams,
                          device="cpu")
    assert any(k.startswith("ssm_") for layer in got["layers"] for k in layer)
    for jl, tl in zip(got["layers"], tm.params["layers"]):
        assert set(jl) == set(tl)
        for k in tl:
            torch.testing.assert_close(jl[k], tl[k], rtol=0, atol=0)
