"""The port's model-sharding rules against the reference's, on the CPU.

* ``param_specs``, ``opt_state_specs``, ``batch_specs`` and
  ``cache_specs_tree`` equal the reference's for every arch on four
  meshes, leaf for leaf (the port reads its per-layer modules as one
  leaf stacked on axis 0, as the reference stores them). The rules read
  only axis names and sizes, so a stand-in mesh is enough.
* Every case of ``tests/test_sharding.py``, on the port.
* ``placements`` turns specs into DTensor placements, ``("pod",
  "data")`` pod-major; each leaf's local shard on the rank at mesh
  coordinates ``c`` is bitwise the reference's ``addressable_shards``
  on the device at ``c`` for a reduced model under a ``(4, 2)`` mesh
  (the reference in a subprocess with eight forced host devices and
  Auto axes; the port's ranks one at a time on a ``fake`` process
  group, each cutting its shard from the full weights).
"""
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import sharding as TS  # noqa: E402
from repro_torch.launch.sharding import P  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


class FakeMesh:
    """Axis-name/size stand-in (the rules read only names and sizes)."""

    def __init__(self, shape: dict):
        self._shape = shape
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))

    @property
    def shape(self):
        return dict(self._shape)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "2x2": FakeMesh({"data": 2, "model": 2}),
    "4x2": FakeMesh({"data": 4, "model": 2}),
}
MESH1, MESH2 = MESHES["16x16"], MESHES["2x16x16"]


def _same_tree(got, want, where=""):
    """Two spec trees equal leaf for leaf (dicts by key)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
        return
    assert isinstance(want, JP), where
    assert got == P(*want), (where, got, want)


def _ref_shapes(arch):
    cfg = JR.get_config(arch)
    return cfg, jax.eval_shape(lambda: JM.init_params(cfg,
                                                      jax.random.PRNGKey(0)))


def _specs(arch, mesh):
    cfg = TR.get_config(arch)
    params = TM.init_params(cfg, 0, "meta")
    return cfg, params, TS.param_specs(params, mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JR.ARCH_NAMES)
def test_param_and_opt_specs_equal_the_reference(arch, mesh):
    jcfg, shp = _ref_shapes(arch)
    m = MESHES[mesh]
    want = JS.param_specs(shp, m)
    _, params, got = _specs(arch, m)
    _same_tree(got, want)
    want_o = JS.opt_state_specs(jax.eval_shape(JA.init, shp), want, m)
    got_o = TS.opt_state_specs(None, got, m)
    assert set(got_o) == set(want_o)
    for k in ("m", "v", "master"):
        _same_tree(got_o[k], want_o[k])
    assert got_o["step"] == P(*want_o["step"])


def _shape_tree(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_equal_the_reference(mesh):
    m = MESHES[mesh]
    for arch in JR.ARCH_NAMES:
        jcfg, tcfg = JR.get_config(arch), TR.get_config(arch)
        for name in TR.SHAPES:
            ok, _ = TR.shape_applicable(tcfg, TR.SHAPES[name])
            if not ok:
                with pytest.raises(ValueError):
                    TR.input_specs(tcfg, name)
                continue
            jspec, tspec = JR.input_specs(jcfg, name), TR.input_specs(tcfg,
                                                                      name)
            if "cache" in jspec:
                assert _shape_tree(jspec["cache"]) == TS.shape_tree(
                    tspec["cache"]), (arch, name)
                assert {k: jnp.dtype(v.dtype).name
                        for k, v in jspec["cache"].items()} == {
                    k: str(v.dtype).removeprefix("torch.")
                    for k, v in tspec["cache"].items()}
                _same_tree(TS.cache_specs_tree(tspec["cache"], m),
                           JS.cache_specs_tree(jspec["cache"], m),
                           f"{arch} {name}")
                jtok = {"token": jspec["token"]}
                _same_tree(TS.batch_specs({"token": tspec["token"]}, m),
                           JS.batch_specs(jtok, m))
                continue
            assert _shape_tree(jspec) == TS.shape_tree(tspec), (arch, name)
            assert {k: jnp.dtype(v.dtype).name for k, v in jspec.items()} \
                == {k: str(v.dtype).removeprefix("torch.")
                    for k, v in tspec.items()}, (arch, name)
            _same_tree(TS.batch_specs(tspec, m), JS.batch_specs(jspec, m),
                       f"{arch} {name}")


def test_spec_equality_keeps_the_references():
    assert P("data") == P(("data",)) == JP("data")
    assert P("a") != P("a", None)
    assert P() != P(None)
    assert hash(P("data")) == hash(P(("data",)))
    assert len({P("data"), P(("data",))}) == 1


# ------------------------------------ the cases of tests/test_sharding.py --
def test_dense_rules_single_pod():
    _, _, spec = _specs("olmo-1b", MESH1)
    assert spec["embed"]["table"] == P("model", "data")
    assert spec["unembed"]["w"] == P("data", "model")
    # stacked layer leaves get the leading None
    assert spec["layers"]["attn"]["wq"] == P(None, "data", "model")
    assert spec["layers"]["mlp"]["w_down"] == P(None, "model", "data")


def test_multi_pod_fsdp_spans_pods():
    _, _, spec = _specs("olmo-1b", MESH2)
    assert spec["layers"]["attn"]["wq"] == P(None, ("pod", "data"), "model")
    assert spec["embed"]["table"] == P("model", ("pod", "data"))


def test_odd_vocab_falls_back_replicated():
    _, _, spec = _specs("whisper-medium", MESH1)
    assert spec["embed"]["table"] == P(None, "data")
    assert spec["unembed"]["w"] == P("data", None)


def test_moe_ep_when_divisible_else_tp():
    _, _, spec = _specs("qwen2-moe-a2.7b", MESH1)   # 60 experts: TP fallback
    assert spec["layers"]["moe"]["w_gate"] == P(None, None, "data", "model")
    _, _, spec16 = _specs("grok-1-314b", MESH1)     # 8 experts: TP fallback
    assert spec16["layers"]["moe"]["w_gate"] == P(None, None, "data", "model")
    _, _, spec2 = _specs("qwen2-moe-a2.7b", MESHES["2x2"])   # EP
    assert spec2["layers"]["moe"]["w_gate"] == P(None, "model", "data", None)


def test_cache_specs_shard_heads_or_seq():
    cfg = TR.get_config("deepseek-coder-33b")   # kv=8: heads don't divide
    spec = TS.cache_specs_tree(TM.cache_specs(cfg, 128, 1024), MESH1)
    assert spec["k"] == P(None, "data", None, "model", None)
    cfg2 = TR.get_config("olmo-1b")             # kv=16: heads divide
    spec2 = TS.cache_specs_tree(TM.cache_specs(cfg2, 128, 1024), MESH1)
    assert spec2["k"] == P(None, "data", "model", None, None)


def test_cache_long_context_batch1_seq_sharded():
    cfg = TR.get_config("zamba2-1.2b")
    spec = TS.cache_specs_tree(TM.cache_specs(cfg, 1, 524_288), MESH1)
    # B=1 can't shard the batch → sequence-parallel over the data axis
    assert spec["attn_k"] == P(None, None, "model", "data", None)


def test_batch_specs():
    specs = {
        "tokens": torch.empty((256, 4096), dtype=torch.int32, device="meta"),
        "weight": torch.empty((256,), device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }
    out = TS.batch_specs(specs, MESH1)
    assert out["tokens"] == P("data", None)
    assert out["weight"] == P("data")
    assert out["pos"] == P()
    out2 = TS.batch_specs(specs, MESH2)
    assert out2["tokens"] == P(("pod", "data"), None)


def test_every_param_spec_divides():
    """No rule may emit a non-divisible sharding for any arch (the
    validator must have cleaned it up)."""
    sizes = MESH2.shape
    for arch in TR.ARCH_NAMES:
        _, params, spec = _specs(arch, MESH2)
        shapes = TS.shape_tree(params)

        def check(shape, sp, where):
            if isinstance(shape, dict):
                for k in shape:
                    check(shape[k], sp[k], f"{where}/{k}")
                return
            for dim, ax in zip(shape, tuple(sp) + (None,) * 9):
                if ax is None:
                    continue
                prod = int(np.prod([sizes[a] for a in (
                    ax if isinstance(ax, tuple) else (ax,))]))
                assert dim % prod == 0, (arch, where, shape, sp)

        check(shapes, spec, arch)


# ------------------------------------------------------------ placements --
def _fake_rank(rank: int, world: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _end_fake():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def test_placements_are_pod_major_and_mesh_ordered():
    from torch.distributed.tensor import Replicate, Shard

    _fake_rank(0, 512)
    try:
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert TS.placements(P(("pod", "data"), "model"), mesh) == (
            Shard(0), Shard(0), Shard(1))
        assert TS.placements(P(None, "model"), mesh) == (
            Replicate(), Replicate(), Shard(1))
        with pytest.raises(ValueError, match="order"):
            TS.placements(P(("data", "pod")), mesh)
        t = TS.distribute_tensor(torch.arange(64.0).reshape(64, 1),
                                 P(("pod", "data")), mesh)
        assert t.to_local().shape == (2, 1)     # 64 rows over 2·16 ranks
    finally:
        _end_fake()


_ADDRESSABLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import pickle
    import jax, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.launch import sharding
    params = pickle.load(open(sys.argv[1], "rb"))
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    specs = sharding.param_specs(params, mesh)
    coord = {d.id: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    sflat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    for (path, leaf), spec in zip(flat, sflat):
        a = jax.device_put(leaf, NamedSharding(mesh, spec))
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[name] = {coord[s.device.id]: np.asarray(s.data)
                     for s in a.addressable_shards}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b"])
def test_local_shards_are_the_references_per_device_shards(arch):
    jcfg = JR.get_config(arch).reduced()
    host = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "p.pkl"), os.path.join(tmp, "s.pkl")
        with open(src, "wb") as f:
            pickle.dump(host, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c", _ADDRESSABLE, src, dst],
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        with open(dst, "rb") as f:
            want = pickle.load(f)
    tcfg = TR.get_config(arch).reduced()
    checked = 0
    try:
        for rank in range(8):
            _fake_rank(rank, 8)
            from torch.distributed.device_mesh import DeviceMesh

            mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                              mesh_dim_names=("data", "model"))
            coords = tuple(mesh.get_coordinate())
            params = convert.params_from_numpy(tcfg, host, "cpu")
            TS.distribute(params, TS.param_specs(params, mesh), mesh)
            for name, t in params.named_parameters():
                parts = name.split(".")
                if parts[0] in ("layers", "enc_layers"):
                    layer = int(parts[1])
                    key = "/".join([parts[0]] + parts[2:])
                    ref = want[key][coords][layer]
                else:
                    ref = want["/".join(parts)][coords]
                local = t.to_local().numpy()
                assert local.shape == ref.shape, (name, coords)
                np.testing.assert_array_equal(
                    local.view(np.uint8), np.ascontiguousarray(ref).view(
                        np.uint8), err_msg=f"{name} at {coords}")
                checked += 1
    finally:
        _end_fake()
    assert checked == 8 * len(list(params.parameters()))
