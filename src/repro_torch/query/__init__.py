"""The continuous query plane: standing queries answered at the root.

``registry`` declares the queries, ``sketches`` holds the mergeable
quantile and heavy-hitter sketches, and ``compiler`` evaluates a
registry (or several tenants' registries) from one window sample.
"""
from repro_torch.query.registry import QueryRegistry, QuerySpec

__all__ = ["QueryRegistry", "QuerySpec"]
