"""The small-table embedding lookup (``models/layers.py``,
``_SmallTableLookup``), which the card takes for tables of at most
``SMALL_TABLE_ROWS`` rows (BERT's token types) so that two runs give the
same gradient bits: the library's CUDA backward sums a row's positions with
atomics in no fixed order (``bisect_cli_runs.py`` found the token-type
gradient to be where two CLI runs on the card first part).

Here on the CPU: the forward equals ``F.embedding``'s bit for bit, and the
gradient equals the float64 sum of the rows' positions within fp32
rounding (1e-6 of the largest row) and ``F.embedding``'s within the same,
for a table every position shares, a table of two rows and one of the
largest size, with inputs made with numpy from a seed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from d2r_tpu_torch.models.layers import SMALL_TABLE_ROWS, _SmallTableLookup


@pytest.mark.parametrize("rows", [1, 2, SMALL_TABLE_ROWS])
def test_small_table_lookup_matches_embedding(rows):
    rng = np.random.default_rng(rows)
    ids = torch.from_numpy(rng.integers(0, rows, size=(8, 64)))
    if rows == 2:
        ids[:, 5:] = 0    # most positions share row 0, as token types do
    table = rng.standard_normal((rows, 24)).astype(np.float32)
    g = rng.standard_normal((8, 64, 24)).astype(np.float32)
    w_ref = torch.from_numpy(table).requires_grad_()
    w = torch.from_numpy(table).requires_grad_()
    ref = F.embedding(ids, w_ref)
    got = _SmallTableLookup.apply(ids, w)
    assert torch.equal(got, ref)
    ref.backward(torch.from_numpy(g))
    got.backward(torch.from_numpy(g))
    want = np.zeros((rows, 24))
    np.add.at(want, ids.numpy().reshape(-1), g.reshape(-1, 24).astype(np.float64))
    tol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(w.grad.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(w.grad.numpy(), w_ref.grad.numpy(), rtol=0, atol=tol)
