"""Port parity of the MoE architectures, slice 1 of 3: each one's tiny GGUF
(tests/test_torch_fixtures.py::arch_spec: MOE_SPECS, or ref_arch_specs'
tensor sets) through both packages on the dense cache, and on the paged
cache for mixtral, gpt-oss and qwen3moe (test_torch_fixtures.arch_parity_tests)."""

import pytest

pytest.importorskip("jax")

from test_torch_fixtures import MOE_REGISTERED, arch_parity_tests, torch_one_thread  # noqa: F401

models, test_dense_cache_matches_jax, test_paged_cache_matches_jax = arch_parity_tests(
    MOE_REGISTERED[0::3])
