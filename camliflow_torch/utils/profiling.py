"""Training telemetry helpers: the port's copy of camliflow_tpu/utils/
profiling.py's `BadLossChecker`."""

from __future__ import annotations

import math


class BadLossChecker:
    """Detects a streak of NaN, infinite or over-threshold losses, so the
    trainer aborts on divergence instead of training through garbage."""

    def __init__(self, threshold: float = 1e5, patience: int = 20):
        self.threshold = threshold
        self.patience = patience
        self.streak = 0

    def check(self, loss: float) -> bool:
        """True when training should abort."""
        bad = (not math.isfinite(loss)) or abs(loss) > self.threshold
        self.streak = self.streak + 1 if bad else 0
        return self.streak >= self.patience
