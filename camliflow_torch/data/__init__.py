"""Eval-only data reading for the `things` protocol: the FlyingThings3D
reader, the KITTI flow-PNG codec and a sequential batch loader. OpenCV is
imported only where a PNG is decoded."""
