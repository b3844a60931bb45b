"""What each rank of a spawned mesh runs in the mesh tests.

The rank processes import this module (never JAX, never the reference):
``run_rank`` drives the port's mesh data plane through the scenarios a
job names and returns host arrays, which the tests hold against the
reference's SPMD functions under ``jax.vmap`` and against each other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.api.pipeline import restore_state, save_state
from repro_torch.api.spec import PipelineSpec, SpecError, TenantSpec
from repro_torch.checkpoint import manager
from repro_torch.data import stream as S
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.obs.metrics import metrics_text
from repro_torch.obs.telemetry import snapshot
from repro_torch.query.registry import QuerySpec


def host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return [host(v) for v in x]
    return x


def leaves(tree) -> list:
    """The tensor leaves of a state, in order, as host arrays."""
    if torch.is_tensor(tree):
        return [host(tree)]
    return [x for part in tree for x in leaves(part)]


def window_answers(wa) -> dict:
    return {k: host(v) for k, v in wa._asdict().items() if v is not None}


def tenant_spec(name: str, queries) -> TenantSpec:
    """A tenant from its queries' field dicts."""
    return TenantSpec(name=name, queries=tuple(
        QuerySpec(**q) for q in queries))


def run_rank(n: int, device: str, backend: str, job: dict) -> dict:
    """Every scenario of ``job`` on this rank; see ``tests/
    test_torch_spmd.py`` for what each one holds."""
    mesh = make_data_mesh(n, device=device, backend=backend)
    vals, strs = job["values"], job["strata"]
    t, m = vals.shape
    out: dict = {"rank": mesh.rank, "device": str(mesh.device)}

    def batches(x, v=vals, s=strs, lo=0, hi=None):
        return S.rows_to_interval_batch(v[lo:hi], s[lo:hi],
                                        np.full((len(v[lo:hi]),), m), x)

    if "tenant" in job:
        spec = PipelineSpec.from_dict(job["tenant"])
        x = spec.topology.num_strata
        pipe = api.compile(spec, mesh=mesh)
        reset_launches()
        mesh.reset_ledger()
        st, wa = pipe.run_epoch(pipe.init(), pipe.default_key, batches(x))
        out["tenant"] = dict(
            wa=window_answers(wa), qstate=leaves(st.qstate),
            tick=int(st.tick), ledger=list(mesh.ledger),
            launches=dict(LAUNCHES), layout=pipe.plan.layout(),
            local_budget=pipe.local_budget,
            summary_bytes=pipe.summary_bytes_per_window,
            reservoir_bytes=pipe.reservoir_bytes_per_window)
        if job.get("resume"):
            s2, wa_a = pipe.run_epoch(pipe.init(), pipe.default_key,
                                      batches(x, hi=2))
            s2, wa_b = pipe.run_epoch(s2, pipe.default_key,
                                      batches(x, lo=2))
            out["resume"] = [window_answers(wa_a), window_answers(wa_b)]
        if job.get("errors"):
            errs = {}
            odd = S.rows_to_interval_batch(vals, strs, np.full((t,), m), x,
                                           width=m + 1)
            try:
                pipe.run_epoch(pipe.init(), pipe.default_key, odd)
            except SpecError as e:
                errs["indivisible"] = str(e)
            errs["clamp"] = pipe.clamp_budgets([10 ** 9])
            out["errors"] = errs
    if "kinds" in job:
        spec = PipelineSpec.from_dict(job["kinds"])
        pipe = api.compile(spec, mesh=mesh)
        st, wa = pipe.run_epoch(pipe.init(), pipe.default_key,
                                batches(spec.topology.num_strata))
        out["kinds"] = dict(wa=window_answers(wa), qstate=leaves(st.qstate),
                            layout=pipe.plan.layout())
    if "exact" in job:
        spec = PipelineSpec.from_dict(job["exact"])
        pipe = api.compile(spec, mesh=mesh)
        _, wa = pipe.run_epoch(pipe.init(), pipe.default_key,
                               batches(1, s=np.zeros_like(strs)))
        out["exact"] = dict(wa=window_answers(wa),
                            local_budget=pipe.local_budget)
    for name, d in job.get("free", {}).items():
        spec = PipelineSpec.from_dict(d)
        pipe = api.compile(spec, mesh=mesh)
        mesh.reset_ledger()
        _, (s, mq) = pipe.run_epoch(pipe.init(), pipe.default_key,
                                    batches(spec.topology.num_strata))
        out.setdefault("free", {})[name] = dict(
            sum=host(s.estimate), sum_var=host(s.variance),
            mean=host(mq.estimate), mean_var=host(mq.variance),
            ledger=list(mesh.ledger), local_budget=pipe.local_budget,
            root_budget=pipe.root_budget)
        if job.get("errors") and "no_budgets" not in out.get("errors", {}):
            try:
                pipe.run_epoch((), pipe.default_key,
                               batches(spec.topology.num_strata),
                               budgets=[64])
            except SpecError as e:
                out.setdefault("errors", {})["no_budgets"] = str(e)
    if "churn" in job:
        out["churn"] = _churn(mesh, job["churn"], batches)
    if "ckpt" in job:
        out["ckpt"] = _checkpoint(mesh, job["ckpt"], batches)
    if "metrics" in job:
        spec = PipelineSpec.from_dict(job["metrics"])
        pipe = api.compile(spec, mesh=mesh)
        st, wa = pipe.run_epoch(pipe.init(), pipe.default_key,
                                batches(spec.topology.num_strata))
        out["metrics"] = dict(
            text=metrics_text(pipeline=pipe, state=st),
            snapshot=snapshot(st), windows=int(host(wa.ok).sum()),
            summary_bytes=pipe.summary_bytes_per_window)
    return out


def _churn(mesh, job, batches) -> dict:
    """Epoch A with the first tenants, admit a tenant, epoch B, retire
    one, epoch C: each epoch's answers, and the states' leaves."""
    spec = PipelineSpec.from_dict(job["spec"])
    x = spec.topology.num_strata
    pipe = api.compile(spec, mesh=mesh)
    out = {}
    st, wa = pipe.run_epoch(pipe.init(), pipe.default_key, batches(x, hi=2))
    out["A"] = window_answers(wa)
    pipe, st = pipe.admit(st, tenant_spec(*job["admit"]))
    out["admitted_qstate"] = leaves(st.qstate)
    st, wa = pipe.run_epoch(st, pipe.default_key, batches(x, lo=2))
    out["B"] = window_answers(wa)
    pipe, st = pipe.retire(st, job["retire"])
    st, wa = pipe.run_epoch(st, pipe.default_key, batches(x, hi=2))
    out["C"] = window_answers(wa)
    out["qstate"] = leaves(st.qstate)
    out["layout"] = pipe.plan.layout()
    return out


def _checkpoint(mesh, job, batches) -> dict:
    """Save after epoch A, then epoch B twice: from the state in hand and
    from a fresh pipeline restored from the checkpoint."""
    spec = PipelineSpec.from_dict(job["spec"])
    x = spec.topology.num_strata
    root = job["root"]
    pipe = api.compile(spec, mesh=mesh)
    st, _ = pipe.run_epoch(pipe.init(), pipe.default_key, batches(x, hi=2))
    save_state(root, 1, st, pipeline=pipe)
    _, wa_direct = pipe.run_epoch(st, pipe.default_key, batches(x, lo=2))
    fresh = api.compile(spec, mesh=mesh)
    st2, meta = restore_state(root, fresh)
    restored = leaves(st2)
    _, wa_resumed = fresh.run_epoch(st2, fresh.default_key,
                                    batches(x, lo=2))
    man = manager.read_manifest(root, 1)
    return dict(direct=window_answers(wa_direct),
                resumed=window_answers(wa_resumed),
                restored=restored, state=leaves(st),
                shapes=[tuple(l["shape"]) for l in man["leaves"]],
                has_slots="slots" in meta)


def fail_or_wait(n: int, hang: bool) -> None:
    """Rank 1 raises (or, with ``hang``, never reaches the collective);
    rank 0 waits in a collective for it."""
    mesh = make_data_mesh(n, device="cpu", backend="gloo")
    if mesh.rank == 1:
        if hang:
            import time

            time.sleep(600)
        raise RuntimeError("planted failure on rank 1")
    mesh.psum(torch.ones(1))
