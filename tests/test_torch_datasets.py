"""The port's selectivity-matched query windows against the reference's.

The port finds each window's K nearest records through a grid of the MBR
centres; the reference scans every record. The windows must be equal, also
where the K-th distance ties (a store of records each present three times).
"""
import numpy as np
import pytest

pytest.importorskip("jax")   # the reference package imports jax

from repro.core import datasets as rdata  # noqa: E402
from repro_torch.core import datasets as tdata  # noqa: E402


@pytest.mark.parametrize("selectivity", [1e-4, 2e-3, 0.0105, 0.3])
@pytest.mark.parametrize("name,n,repeat", [
    ("mixed", 6000, 1), ("cluster", 6000, 1), ("points", 6000, 1),
    ("mixed", 700, 3)])
def test_make_query_windows_matches_reference(name, n, repeat, selectivity):
    take = np.repeat(np.arange(n), repeat)
    got = tdata.make_query_windows(
        tdata.generate(name, n, seed=2).take(take), selectivity, 150, seed=5)
    want = rdata.make_query_windows(
        rdata.generate(name, n, seed=2).take(take), selectivity, 150, seed=5)
    assert got.shape == (150, 4)
    np.testing.assert_array_equal(got, want)


def test_make_query_windows_of_none():
    gs = tdata.generate("mixed", 100, seed=1)
    assert tdata.make_query_windows(gs, 0.01, 0).shape == (0, 4)
