"""Ops. `geometry`, `ids`, `image`, `gridsample` and `correlation` are plain
PyTorch; `knn`, `fps`, `interp`, `corr3d`, `update2d`, `update3d`, `gather`
and `clfm` each hold CUDA kernels, their plain versions and the wrappers
that pick between them by the tensors' device."""
