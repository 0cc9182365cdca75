"""Frozen copies of the PyTorch/CUDA package's modules that the reference
cannot write apart from it (HEM with its kNN, and the rasterizer's
projection and SH formulas with their 3D math), copied as the package
stood when the benchmark was defined, with imports pointed here, the
as_tensor helper inlined and HEM's native backend left out. They import
nothing of the package, so a later change to the package cannot move its
own yardstick."""
