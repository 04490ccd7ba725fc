"""The chunked train step against the eager step in 'bucketed' shape mode:
the check of test_torch_chunked_modes.py (K = 3 steps a call against 3
eager calls, bitwise, `disc_iters` 2 and the cosine schedule), in a file of
its own so that its full-width CPU run goes to another test worker than the
padded case's."""

import pytest

import test_torch_chunked_modes as base


@pytest.mark.parametrize("mode", ["bucketed"])
def test_chunk_equals_sequential_eager_steps(mode):
    base.test_chunk_equals_sequential_eager_steps(mode)
