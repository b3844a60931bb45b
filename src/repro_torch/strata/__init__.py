"""Adaptive stratification: online stratum split/merge as same-shape
edits of the key→stratum routing table (see ``repro_torch.strata.manager``)."""
from repro_torch.strata.manager import (StratumManager, StratumOp,
                                        remap_tree_state)

__all__ = ["StratumManager", "StratumOp", "remap_tree_state"]
