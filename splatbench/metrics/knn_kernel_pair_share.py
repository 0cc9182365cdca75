"""The share of the neighbour search's pairs that the brute kNN kernel
swept: the program's `knn.kernel_pairs` counter (Q·N of each launch of
`csrc/knn_brute.cu`, counted by `ops/knn.py::knn_brute`) over its
`knn.pairs` (every brute and grid search), over the traced jobs
(`splatbench/program_spans.py`). 1.0 where every search runs on the
kernel; None where the program counts no kernel pairs (a version of it
without the kernel). Not yet an entry of BENCHMARK.json's `per_layer`:
`test_splatbench_program_spans.py` holds that list's last entries to be
its own eleven (PERF.md, Open questions)."""

from splatbench.program_spans import counter


def read(rec):
    kernel = counter(rec, "knn.kernel_pairs")
    pairs = counter(rec, "knn.pairs")
    if kernel is None or not pairs:
        return None
    return kernel / pairs
