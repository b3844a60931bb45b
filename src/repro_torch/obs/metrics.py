"""/metrics-style exposition.

The port's own copy of ``repro.obs.metrics``: a small counter/gauge
registry rendering the Prometheus text format
(https://prometheus.io/docs/instrumenting/exposition_formats/), plus
:func:`render_pipeline_metrics`, which folds the telemetry leaves, the
span tracer, the plan and program cache stats and the budget controller
into one snapshot (what ``launch.analytics`` reports under
``metrics``), with the reference's metric names.

:func:`parse_prometheus_text` is the inverse, for tests.
"""
from __future__ import annotations

import math
from typing import Any


def _fmt_value(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


class MetricsRegistry:
    """Ordered counter/gauge registry with labels.

    ``counter``/``gauge`` record a sample keyed by (name, labels); the
    last write for a key wins (snapshots are idempotent). ``to_text()``
    renders Prometheus exposition text: one ``# HELP``/``# TYPE``
    header per metric family, then its samples.
    """

    def __init__(self):
        # name -> (type, help, {label_tuple: value})
        self._families: dict[str, tuple[str, str, dict]] = {}

    def _record(self, kind: str, name: str, value: float, help_: str,
                labels: dict[str, Any] | None) -> None:
        fam = self._families.get(name)
        if fam is None:
            fam = (kind, help_, {})
            self._families[name] = fam
        key = tuple(sorted((labels or {}).items()))
        fam[2][key] = float(value)

    def counter(self, name: str, value: float, help_: str = "",
                **labels) -> None:
        self._record("counter", name, value, help_, labels)

    def gauge(self, name: str, value: float, help_: str = "",
              **labels) -> None:
        self._record("gauge", name, value, help_, labels)

    def to_text(self) -> str:
        lines: list[str] = []
        for name, (kind, help_, samples) in self._families.items():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for key, value in samples.items():
                if key:
                    lab = ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in key)
                    lines.append(f"{name}{{{lab}}} {_fmt_value(value)}")
                else:
                    lines.append(f"{name} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Parse exposition text back into
    ``{name: {"type": str, "samples": {label_tuple: float}}}``.
    Raises ``ValueError`` on malformed lines."""
    out: dict[str, dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4:
                raise ValueError(f"malformed TYPE line: {raw!r}")
            _, _, name, kind = parts
            out.setdefault(name, {"type": kind, "samples": {}})
            out[name]["type"] = kind
            continue
        if line.startswith("#"):
            continue
        # sample: name[{labels}] value
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_raw, value_raw = rest.rsplit("}", 1)
            labels = []
            for item in _split_labels(labels_raw):
                if "=" not in item:
                    raise ValueError(f"malformed label in: {raw!r}")
                k, v = item.split("=", 1)
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"unquoted label value in: {raw!r}")
                labels.append((k.strip(), v[1:-1]))
            key = tuple(sorted(labels))
        else:
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"malformed sample line: {raw!r}")
            name, value_raw = parts
            key = ()
        name = name.strip()
        value_raw = value_raw.strip()
        try:
            value = float(value_raw)
        except ValueError as e:
            raise ValueError(f"bad value in: {raw!r}") from e
        out.setdefault(name, {"type": "untyped", "samples": {}})
        out[name]["samples"][key] = value
    if not out:
        raise ValueError("empty metrics text")
    return out


def _split_labels(s: str) -> list[str]:
    """Split 'a="x",b="y,z"' on commas outside quotes."""
    items, cur, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        items.append("".join(cur))
    return [i for i in items if i.strip()]


def render_pipeline_metrics(pipeline=None, state=None, tracer=None,
                            controller=None,
                            extra: dict | None = None) -> MetricsRegistry:
    """Aggregate every observability source into one registry. All
    arguments are optional; ``extra`` is a flat ``{gauge_name: value}``
    dict of driver-specific numbers."""
    from repro_torch.api.pipeline import program_cache_stats
    from repro_torch.obs.telemetry import snapshot, tenant_rel_bounds
    from repro_torch.query.compiler import plan_cache_stats

    reg = MetricsRegistry()

    snap = snapshot(state) if state is not None else None
    if snap is not None:
        for lvl, row in enumerate(snap["levels"]):
            lab = {"level": str(lvl)}
            reg.counter("repro_items_in_total", row["items_in"],
                        "Items offered at each level's flush", **lab)
            reg.counter("repro_items_kept_total", row["items_kept"],
                        "Items kept/forwarded at each level", **lab)
            reg.counter("repro_level_flushes_total", row["flushes"],
                        "Non-empty flushes per level", **lab)
            reg.counter("repro_saturation_hits_total",
                        row["saturation_hits"],
                        "Flushes where a level kept every offered item",
                        **lab)
            reg.gauge("repro_effective_fraction",
                      row["effective_fraction"],
                      "Realized kept/offered fraction per level", **lab)
        for s, row in enumerate(snap["strata"]):
            reg.gauge("repro_stratum_effective_fraction",
                      row["effective_fraction"],
                      "Realized per-stratum sampling fraction at the root",
                      stratum=str(s))
        reg.counter("repro_windows_total", snap["windows"],
                    "Flushed root windows")
        reg.gauge("repro_realized_bound_2sigma", snap["bound_2sigma"],
                  "Realized +/-2 sigma bound on the SUM estimate")
        reg.gauge("repro_realized_rel_bound_2sigma",
                  snap["rel_bound_2sigma"],
                  "Realized relative +/-2 sigma bound on the SUM estimate")
        reg.counter("repro_spmd_summary_bytes_total", snap["merge_bytes"],
                    "Sketch-summary bytes shipped across the mesh axis")
        reg.counter("repro_straggler_late_shards_total",
                    snap["late_shards"],
                    "Shards that missed the window deadline")
        reg.counter("repro_straggler_widened_windows_total",
                    snap["widened_windows"],
                    "Windows published with absent shards (widened bounds)")
        if pipeline is not None:
            for tenant, bnd in tenant_rel_bounds(pipeline, state).items():
                reg.gauge("repro_tenant_rel_bound", bnd,
                          "Per-tenant worst realized relative error bound",
                          tenant=tenant)

    st = plan_cache_stats()
    total = st["builds"] + st["hits"]
    reg.counter("repro_plan_cache_builds_total", st["builds"],
                "SlotPlanCore cache misses (fresh builds)")
    reg.counter("repro_plan_cache_hits_total", st["hits"],
                "SlotPlanCore cache hits")
    reg.gauge("repro_plan_cache_hit_rate",
              st["hits"] / total if total else 0.0,
              "SlotPlanCore cache hit rate")
    st = program_cache_stats()
    total = st["misses"] + st["hits"]
    reg.counter("repro_program_cache_misses_total", st["misses"],
                "Epoch-program cache misses (programs built)")
    reg.counter("repro_program_cache_hits_total", st["hits"],
                "Epoch-program cache hits")
    reg.gauge("repro_program_cache_hit_rate",
              st["hits"] / total if total else 0.0,
              "Epoch-program cache hit rate")

    if tracer is not None:
        for name, secs in sorted(tracer.durations.items()):
            reg.counter("repro_span_seconds_total", secs,
                        "Cumulative wall-time per span name", span=name)
        for name, n in sorted(tracer.calls.items()):
            reg.counter("repro_span_calls_total", n,
                        "Span invocations per span name", span=name)
        for name, n in sorted(tracer.counters.items()):
            reg.counter(f"repro_{name}_total", n,
                        "Tracer-side event counter")

    if controller is not None:
        reg.gauge("repro_budget_size", getattr(controller, "size", 0),
                  "Current controller sample-budget size")
        lr = getattr(controller, "last_rel_error", None)
        if lr is not None:
            reg.gauge("repro_budget_last_rel_error", lr,
                      "Last relative error fed to the budget controller")
        ll = getattr(controller, "last_latency_s", None)
        if ll is not None:
            reg.gauge("repro_budget_last_latency_seconds", ll,
                      "Last epoch latency fed to the budget controller")

    for name, value in (extra or {}).items():
        reg.gauge(name, float(value))
    return reg


def metrics_text(pipeline=None, state=None, tracer=None, controller=None,
                 extra: dict | None = None) -> str:
    """One-call Prometheus-text snapshot of everything observable."""
    return render_pipeline_metrics(
        pipeline=pipeline, state=state, tracer=tracer,
        controller=controller, extra=extra).to_text()
