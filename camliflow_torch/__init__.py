"""CamLiFlow in PyTorch with hand-written CUDA kernels for Hopper.

The port of `camliflow_tpu` (the JAX reference, which stays beside it). It
mirrors that package's layout and its channel-last conventions (points
`[B, N, 3]`, features `[B, N, C]`, image maps NHWC, indices int32):

- ``ops``      geometry, IDS, image and correlation ops, and the kernel
               modules (knn, fps, interp, corr3d, update2d, update3d,
               gather, clfm), each CUDA kernels plus their plain PyTorch
               versions
- ``csrc``     the CUDA sources and their nvcc/ctypes build
- ``nn``       dense/norm/act blocks, point convolutions, ResNet, CLFM
- ``models``   CamLiRAFT, CamLiRAFT-L and RAFT (eval) and the model registry
- ``runtime``  the evaluator (the things, Sintel and scene-flow protocols,
               one batch ahead), the KITTI submission writer and the JAX
               weight bridge
- ``postprocess`` the rigid-background refinement (host, OpenCV's solvers)
- ``data``     the eval readers (FlyingThings3D, KITTI, Sintel and the
               scene-flow protocols' sets), their codecs and a PNG codec
- ``utils``    config composition, torch setup, the flow colour wheel
- ``eval.py``, ``kitti_submission.py``, ``refine_background.py``,
  ``demo.py``  the entry points

It imports no JAX.
"""
