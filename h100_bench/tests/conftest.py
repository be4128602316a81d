"""Fixtures of the harness's CPU tests (h100_bench_support has the
helpers)."""

import pytest

from h100_bench_support import make_tiny_copy


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark at the tiny sizes of TINY."""
    return make_tiny_copy(str(tmp_path_factory.mktemp("bench")))
