"""The kNN kernel (`csrc/knn_brute.cu`, `ops/knn.py::knn_brute`) against
the plain form on the card, through the public functions, on each of
`port_scenes.knn_kernel_cases`: `reg200k_hem`'s shapes and the edges.

The tests are marked `card` and skip without a CUDA card. On the card's
machine, from the repo root, with the other kernels' card tests:

    python -m pytest --noconftest tests/test_torch_tile_bin.py tests/test_torch_composite_kernels.py tests/test_torch_knn_kernel.py -m card -q

This file imports no JAX and takes nothing from `conftest.py`, so that it
runs there without either.
"""

import pytest
import torch

from gaussiansplattingregistration_tpu_torch.ops import knn
from port_scenes import knn_kernel_cases, sqdist_rows, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

CASES = ["hem_level0_k32", "normals_level1_k30", "icp_level1_k1", "icp_level3_k1", "k20",
         "k100", "n_not_chunk_multiple", "k_equals_n", "q_below_warp_k30", "q_below_warp_k1",
         "dead_rows_1e12_k32", "dead_rows_1e12_k1", "duplicates_k32", "duplicates_k1",
         "d4_k20"]


@pytest.fixture(scope="module")
def cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    out = {name: (q, d, k) for name, q, d, k, _ in knn_kernel_cases(torch.device("cuda"))}
    assert sorted(out) == sorted(CASES)
    return out


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_knn_kernel_matches_plain_form(cases, name):
    """At least one launch counted; distances bit-equal to the plain
    form's and to the squared distances of the indices returned; indices
    equal to the plain form's but at exact ties; each row ascending by
    (d2, index); the first rows equal to a stable sort of their whole
    distance row."""
    q, d, k = cases[name]
    before = knn.knn_brute.launches
    got = knn.nearest_neighbor(q, d) if k == 1 else knn.knn(q, d, k)
    assert knn.knn_brute.launches - before >= 1
    plain = knn._nearest_blocked(q, d, None) if k == 1 else knn._knn_blocked(q, d, k, None)
    d2, idx = (t.reshape(q.shape[0], k) for t in got)
    pd2, pidx = (t.reshape(q.shape[0], k) for t in plain)
    assert torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    acc, pacc = sqdist_rows(q, d, idx), sqdist_rows(q, d, pidx)
    assert torch.equal(acc.view(torch.int32), d2.view(torch.int32))
    assert int(((idx != pidx) & (acc != pacc)).sum()) == 0
    key_d, key_i = d2[:, 1:], idx[:, 1:]
    assert bool(((d2[:, :-1] < key_d) | ((d2[:, :-1] == key_d) & (idx[:, :-1] < key_i))).all())
    rows = min(q.shape[0], max(1, (64 << 20) // (4 * d.shape[0])), 512)
    full = knn._pairwise_sqdist(q[:rows], d)
    assert torch.equal(idx[:rows], torch.sort(full, dim=1, stable=True).indices[:, :k])
