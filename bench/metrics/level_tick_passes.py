"""Passes a tick of the level ticks over their nodes' slots: over the
program's ``level_tick`` spans in the traced window, each node's radix
passes of τ's search plus its neyman moments' walks of the valid prefix
(``nodes × (radix_passes + moment_windows)``, the kernel's own counts at
the launch's strata), over the traced ticks. ``None`` where the program
records no such span, or no span carries the kernel's regime (the plain
version on the CPU)."""
from harness import program_spans

KEYS = ("nodes", "radix_passes", "moment_windows")


def read(ctx):
    sp = program_spans.spans(ctx)
    if sp is None or not ctx.flows.get("ticks"):
        return None
    lo, hi = ctx.trace.window
    metas = [m for n, s, _, m in sp if n == "level_tick" and lo <= s < hi]
    if not metas or not all(k in m for m in metas for k in KEYS):
        return None
    passes = sum(m["nodes"] * (m["radix_passes"] + m["moment_windows"])
                 for m in metas)
    return passes / ctx.flows["ticks"]
