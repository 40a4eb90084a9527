"""Port parity of the registered architectures, slice 4 of 11: each one's
tiny GGUF (tests/test_torch_fixtures.py::arch_spec) through both packages
on the dense and the paged cache (test_torch_fixtures.arch_parity_tests)."""

import pytest

pytest.importorskip("jax")

from test_torch_fixtures import REGISTERED, arch_parity_tests, torch_one_thread  # noqa: F401

models, test_dense_cache_matches_jax, test_paged_cache_matches_jax = arch_parity_tests(
    REGISTERED[3::11])
