"""Checkpoints of the pipeline state in the reference's on-disk format."""
from repro_torch.checkpoint.manager import (AsyncCheckpointer, latest_step,
                                            read_manifest, restore, save)

__all__ = ["save", "restore", "latest_step", "read_manifest",
           "AsyncCheckpointer"]
