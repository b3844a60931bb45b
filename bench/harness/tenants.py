"""A configuration's tenants on the program's side.

A configuration may carry ``tenants``: a list of ``{"name", "queries":
[...]}``, each query ``{"kind", "name", ...}`` with the arguments of the
matching ``repro_torch.query.QueryRegistry.register_<kind>``. Here they
become the pipeline's ``TenantSpec``s, and the program's sketch state
(``TreeState.qstate``) is cloned on the device after each epoch and read
to the host in the plain reference's layout.
"""
from __future__ import annotations

import numpy as np
import torch


def specs(cfg: dict) -> tuple:
    """The configuration's tenants as ``repro_torch`` ``TenantSpec``s
    (``()`` without any)."""
    from repro_torch.query import QueryRegistry

    out = []
    for tenant in cfg.get("tenants", ()):
        reg = QueryRegistry()
        for q in tenant["queries"]:
            args = {k: v for k, v in q.items() if k not in ("kind", "name")}
            if "qs" in args:
                args["qs"] = tuple(args["qs"])
            getattr(reg, f"register_{q['kind']}")(q["name"], **args)
        out.append(reg.as_tenant(tenant["name"]))
    return tuple(out)


def _map(fn, x):
    """``fn`` over the tensors of nested tuples and named tuples."""
    if torch.is_tensor(x):
        return fn(x)
    parts = [_map(fn, p) for p in x]
    return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)


def clone(qstate):
    """A device copy of the sketch state (the program may reuse the
    buffers of the state it was given)."""
    return _map(torch.clone, qstate)


def host_state(qstate, plan) -> list:
    """The program's sketch state in the reference's layout: per tenant,
    ``{"active", "queries"}``, each query's sketch a dict of numpy arrays
    by field (``None`` for a stateless query). ``plan`` is the program's
    tenant plan, whose ``entries`` say in which group and slot of the
    state each tenant lives."""
    out = []
    for _name, specs_, group, slot in plan.entries:
        mask, stacked = qstate[group]
        queries = []
        for i in range(len(specs_)):
            st = stacked[i]
            if not hasattr(st, "_fields"):
                queries.append(None)
                continue
            queries.append({f: np.asarray(getattr(st, f)[slot].cpu().numpy())
                            for f in st._fields})
        out.append({"active": bool(mask[slot]), "queries": queries})
    return out
