"""Registry of standing queries for the continuous query plane.

The port's own copy of ``repro.query.registry`` (the port imports
nothing of the reference). A ``QuerySpec`` declares one standing query
over the root's windowed sample stream; a ``QueryRegistry`` is an
ordered collection of them. ``registry.compile(num_strata)`` hands the
specs to ``repro_torch.query.compiler``, which evaluates all of them at
the root once per window, inside the scan engine's tick.

Specs are frozen/hashable (tuple-valued fields only) so compiled plans
can close over them inside jitted step factories.

Query kinds and their answer layout (one contiguous f32 slice per query
in the plan's flat answer vector):

    sum / count / mean   1 slot   CLT estimate, bound = 2σ       (§III-D)
    histogram            bins     per-bin count estimate, 2σ
    quantile             len(qs)  value at each quantile; bound = the
                                  sketch's live rank-error ε
    heavy_hitters        2·k      [k keys (as f32), k count estimates];
                                  bound on the estimate slots = CM ε·W
    windowed_quantile    len(qs)  value at each quantile over the LAST
                                  ``window`` root windows (ring of KLL
                                  sub-sketches merged per query); bound =
                                  the merged summary's rank-error ε
    decayed_heavy_hitters 2·k     like heavy_hitters with counts decayed
                                  ``γ = decay`` per window — recent-stream
                                  top-k; bound = CM ε on the decayed
                                  total weight

Caveat: heavy-hitter keys ride the f32 answer vector, which is exact
only for |key| ≤ 2²⁴ (and turns an empty slot's sentinel into 2³¹);
gate consumers on ``est > 0`` and read exact i32 keys from the sketch
state when key IDs can exceed 2²⁴.
"""
from __future__ import annotations

import dataclasses


VALID_KINDS = ("sum", "count", "mean", "histogram", "quantile",
               "heavy_hitters", "windowed_quantile",
               "decayed_heavy_hitters")


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    name: str
    kind: str
    # histogram
    lo: float = 0.0
    hi: float = 1.0
    bins: int = 32
    # quantile sketch (also windowed_quantile)
    qs: tuple = ()
    capacity: int = 256
    # heavy hitters (also decayed_heavy_hitters)
    k: int = 8
    width: int = 1024
    depth: int = 4
    # windowed_quantile: sliding-window span in root windows
    window: int = 8
    # decayed_heavy_hitters: per-window count decay factor
    decay: float = 0.9

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"unknown query kind {self.kind!r}; "
                             f"valid: {VALID_KINDS}")
        if self.kind == "histogram" and not (self.bins > 0
                                             and self.hi > self.lo):
            raise ValueError(f"histogram {self.name!r} needs hi > lo, bins > 0")
        if self.kind in ("quantile", "windowed_quantile"):
            if not self.qs:
                raise ValueError(f"{self.kind} {self.name!r} needs qs")
            object.__setattr__(self, "qs", tuple(float(q) for q in self.qs))
        if self.kind == "windowed_quantile" and int(self.window) < 1:
            raise ValueError(f"windowed_quantile {self.name!r} needs "
                             f"window >= 1, got {self.window}")
        if self.kind in ("heavy_hitters", "decayed_heavy_hitters") \
                and self.width & (self.width - 1):
            raise ValueError(f"{self.kind} {self.name!r} width must be 2^n")
        if self.kind == "decayed_heavy_hitters" \
                and not 0.0 < float(self.decay) < 1.0:
            raise ValueError(f"decayed_heavy_hitters {self.name!r} needs "
                             f"decay in (0, 1), got {self.decay}")

    @property
    def out_width(self) -> int:
        """Slots this query occupies in the plan's flat answer vector."""
        return {"sum": 1, "count": 1, "mean": 1, "histogram": self.bins,
                "quantile": len(self.qs), "heavy_hitters": 2 * self.k,
                "windowed_quantile": len(self.qs),
                "decayed_heavy_hitters": 2 * self.k,
                }[self.kind]


class QueryRegistry:
    """Ordered collection of standing queries (insertion order = answer
    layout order)."""

    def __init__(self, specs: list[QuerySpec] | None = None):
        self._specs: dict[str, QuerySpec] = {}
        for sp in specs or []:
            self.register(sp)

    def register(self, spec: QuerySpec) -> "QueryRegistry":
        if spec.name in self._specs:
            raise ValueError(f"query {spec.name!r} already registered")
        self._specs[spec.name] = spec
        return self

    # Convenience constructors — chainable.
    def register_sum(self, name: str = "sum"):
        return self.register(QuerySpec(name, "sum"))

    def register_count(self, name: str = "count"):
        return self.register(QuerySpec(name, "count"))

    def register_mean(self, name: str = "mean"):
        return self.register(QuerySpec(name, "mean"))

    def register_histogram(self, name: str, lo: float, hi: float,
                           bins: int = 32):
        return self.register(QuerySpec(name, "histogram", lo=lo, hi=hi,
                                       bins=bins))

    def register_quantile(self, name: str, qs, capacity: int = 256):
        return self.register(QuerySpec(name, "quantile", qs=tuple(qs),
                                       capacity=capacity))

    def register_heavy_hitters(self, name: str, k: int = 8,
                               width: int = 1024, depth: int = 4):
        return self.register(QuerySpec(name, "heavy_hitters", k=k,
                                       width=width, depth=depth))

    def register_windowed_quantile(self, name: str, qs, capacity: int = 256,
                                   window: int = 8):
        """Quantiles over the last ``window`` root windows — the serve
        plane's "last N minutes" answer (a stream-so-far ``quantile``
        never forgets old data)."""
        return self.register(QuerySpec(name, "windowed_quantile",
                                       qs=tuple(qs), capacity=capacity,
                                       window=window))

    def register_decayed_heavy_hitters(self, name: str, k: int = 8,
                                       width: int = 1024, depth: int = 4,
                                       decay: float = 0.9):
        """Top-k over an exponentially decayed stream (``decay`` per root
        window) — recent heavy hitters instead of all-time ones."""
        return self.register(QuerySpec(name, "decayed_heavy_hitters", k=k,
                                       width=width, depth=depth,
                                       decay=decay))

    @property
    def specs(self) -> tuple[QuerySpec, ...]:
        return tuple(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def compile(self, num_strata: int):
        """Fuse every registered query into one batched evaluation plan."""
        from repro_torch.query import compiler

        return compiler.CompiledQueryPlan(self.specs, num_strata)

    def shape_signature(self) -> tuple[QuerySpec, ...]:
        """Name-free signature (names canonicalized to ``q0, q1, ...``).
        Tenants whose registries share a signature evaluate as rows of
        one slot group in the slotted tenant plan."""
        from repro_torch.query import compiler

        return compiler.canonical_signature(self.specs)

    def as_tenant(self, name: str):
        """Wrap this registry as one ``repro_torch.api`` pipeline tenant:
        N tenants' registries share one tree (one root evaluation per
        window) with per-tenant answer routing."""
        from repro_torch.api.spec import TenantSpec

        return TenantSpec.from_registry(name, self)

    @classmethod
    def from_tokens(cls, tokens: str) -> "QueryRegistry":
        """Parse the CLI mini-language: comma-separated query tokens.

            sum | count | mean
            hist:<lo>:<hi>:<bins>
            q:<q1>:<q2>:...          (quantile sketch)
            hh[:<k>]                 (heavy hitters)
            wq:<q1>:<q2>:...         (windowed quantile, window 8)
            dhh[:<k>[:<decay>]]      (decayed heavy hitters)

        e.g. ``--queries sum,count,mean,hist:0:100:32,q:0.5:0.9:0.99,hh,
        wq:0.5:0.99,dhh:4:0.9``
        """
        reg = cls()
        for tok in (t.strip() for t in tokens.split(",") if t.strip()):
            parts = tok.split(":")
            head = parts[0]
            try:
                if head in ("sum", "count", "mean"):
                    reg.register(QuerySpec(_unique(reg, head), head))
                elif head == "hist":
                    lo, hi = float(parts[1]), float(parts[2])
                    bins = int(parts[3]) if len(parts) > 3 else 32
                    reg.register_histogram(_unique(reg, "hist"), lo, hi, bins)
                elif head == "q":
                    qs = tuple(float(p) for p in parts[1:])
                    reg.register_quantile(_unique(reg, "quantile"), qs)
                elif head == "hh":
                    k = int(parts[1]) if len(parts) > 1 else 8
                    reg.register_heavy_hitters(_unique(reg, "hh"), k=k)
                elif head == "wq":
                    qs = tuple(float(p) for p in parts[1:])
                    reg.register_windowed_quantile(_unique(reg, "wq"), qs)
                elif head == "dhh":
                    k = int(parts[1]) if len(parts) > 1 else 8
                    decay = float(parts[2]) if len(parts) > 2 else 0.9
                    reg.register_decayed_heavy_hitters(
                        _unique(reg, "dhh"), k=k, decay=decay)
                else:
                    raise ValueError(f"unknown query token {tok!r}")
            except (IndexError, ValueError) as e:
                if isinstance(e, ValueError) and "query token" in str(e):
                    raise
                raise ValueError(
                    f"malformed query token {tok!r} "
                    f"(expected e.g. hist:<lo>:<hi>[:<bins>], "
                    f"q:<q1>[:<q2>...], hh[:<k>], wq:<q1>[:<q2>...], "
                    f"dhh[:<k>[:<decay>]]): {e}") from e
        return reg


def _unique(reg: QueryRegistry, base: str) -> str:
    if base not in reg:
        return base
    i = 2
    while f"{base}{i}" in reg:
        i += 1
    return f"{base}{i}"
