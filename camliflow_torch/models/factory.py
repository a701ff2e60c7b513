"""Model registry: the port's counterpart of camliflow_tpu/models/factory.py's
lookup. Ported so far: CamLiRAFT, CamLiRAFT-L and RAFT."""

from __future__ import annotations

from torch import nn

from . import camliraft, camliraft_l, raft

_REGISTRY: dict[str, type[nn.Module]] = {
    "camliraft": camliraft.CamLiRAFT,
    "camliraft_l": camliraft_l.CamLiRAFTL,
    "raft": raft.RAFT,
}


def model_factory(cfgs) -> type[nn.Module]:
    """Look up a model class by `cfgs["name"]` (or a bare name)."""
    name = cfgs["name"] if isinstance(cfgs, dict) else cfgs
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"Unknown or not yet ported model: {name} (ported: "
            f"{sorted(_REGISTRY)}; see ROADMAP.md Queue 1)"
        )
    return _REGISTRY[name]
