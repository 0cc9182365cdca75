"""Multi-GPU execution on torch.distributed: process groups, meshes, sharded
rasterization, evaluation and the sharded train step.

Torch counterpart of `gaussiansplattingregistration_tpu/parallel/`. One
process per rank (NCCL on GPUs, gloo on the CPU); a `DeviceMesh` with a
`splat` axis (the N Gaussians split over ranks, each rank compositing a
horizontal tile slab) and a `data` axis (cameras and images split over
ranks). Each rank holds its own shard and calls the collectives of
`collectives.py` explicitly, where the JAX package's `shard_map` inserts
them.

Two compositing strategies over the splat axis:
* sharded_raster: all-gather the screen records, composite the rank's own
  tile slab (simple, O(N_total) memory per rank);
* compositor: all-to-all the records into depth buckets, composite each
  bucket over the full grid, all-to-all the tile slabs and fold them front
  to back with the associative over-operator (O(N/D) memory per rank).
"""
