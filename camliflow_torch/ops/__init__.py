"""Ops. `geometry`, `ids`, `image`, `gridsample` and `correlation` are plain
PyTorch; `knn`, `fps`, `interp`, `corr3d` and `update2d` each hold a CUDA
kernel, its plain version and the wrapper that picks between them by the
tensors' device."""
