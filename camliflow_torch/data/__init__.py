"""Eval-only data reading: the FlyingThings3D, KITTI (training and test
splits) and Sintel readers, the four scene-flow protocols' readers, their
file codecs and a sequential batch loader. OpenCV is imported only where a
PNG is decoded."""
