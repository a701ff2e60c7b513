"""Classical-geometry post-processing (KITTI rigid-background refinement)."""

from .refine import mod_flow

__all__ = ["mod_flow"]
