"""Model families ported so far: CamLiRAFT (eval) and CamLiRAFT-L (eval)."""
