"""The port's sharding rules and mesh planners against the JAX package's.

``param_shardings``, ``opt_state_shardings`` (with ``zero1_sharding``)
and ``batch_shardings`` are pure functions of the config, the mesh's axis
sizes and each leaf's key path and shape, so the JAX package's run here
on ``jax.sharding.AbstractMesh`` meshes with no devices: the ten configs
at full width (shapes from ``jax.eval_shape(repro.models.init_lm)``; the
port's rules see the same shapes as meta tensors, nothing allocated) and
at smoke size, on the (1, 1), (2, 1), (4, 1), (16, 16) and (2, 16, 16)
meshes. Specs are compared leaf by leaf, by key path, and must be equal.
``plan_elastic_mesh`` and ``reassign_shards`` are compared over a grid
of inputs, their raises included.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import fault_tolerance as jft
from repro.distributed import sharding as jsh
from repro.models import init_lm as jax_init_lm
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import make_production_mesh, production_axes
from repro_torch.models import init_lm

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SIZES = ("full", "smoke")


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), dict(zip(axes, sizes))


def _configs(arch, size):
    if size == "full":
        return jax_get_config(arch), get_config(arch)
    return jax_smoke_config(arch), smoke_config(arch)


@functools.lru_cache(maxsize=None)
def _shapes(arch, size):
    jcfg, _ = _configs(arch, size)
    return jax.eval_shape(lambda: jax_init_lm(jax.random.PRNGKey(0), jcfg))


def _meta(tree):
    """The JAX shape tree with torch meta tensors for leaves."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), tree)


def _jax_specs(tree):
    return {tsh._path_names(path): tuple(sh.spec) for path, sh in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))}


def _port_specs(tree):
    flat, _ = torch.utils._pytree.tree_flatten_with_path(tree)
    return {tsh._path_names(path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_state_shardings_match_jax(arch, size, mesh):
    jcfg, tcfg = _configs(arch, size)
    jmesh, tmesh = _meshes(mesh)
    shapes = _shapes(arch, size)
    like = _meta(shapes)
    j_p = jsh.param_shardings(jcfg, jmesh, shapes)
    t_p = tsh.param_shardings(tcfg, tmesh, like)
    want_p, got_p = _jax_specs(j_p), _port_specs(t_p)
    assert set(got_p) == set(want_p)
    for path in want_p:
        assert got_p[path] == want_p[path], (path, got_p[path], want_p[path])
    want_o = _jax_specs(jsh.opt_state_shardings(jcfg, jmesh, j_p, shapes))
    got_o = _port_specs(tsh.opt_state_shardings(tcfg, tmesh, t_p, like))
    assert set(got_o) == set(want_o)
    for path in want_o:
        assert got_o[path] == want_o[path], (path, got_o[path], want_o[path])
    if size == "full" and tcfg.sharding == "dp" and mesh != "1x1":
        # ZeRO-1 shards the large leaves of every pure-DP config
        assert any(any(e is not None for e in s) for s in got_o.values())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_shardings_match_jax(mesh):
    jmesh, tmesh = _meshes(mesh)
    for arch in sorted(ARCHS):
        for jcfg, tcfg in (_configs(arch, "full"), _configs(arch, "smoke")):
            for b in (1, 2, 4, 6, 8, 16, 24, 256, 512, 1024):
                shapes = {"tokens": jax.ShapeDtypeStruct((b, 16), "int32"),
                          "embeds": jax.ShapeDtypeStruct((b, 16, 8),
                                                         "float32")}
                want = {k: tuple(v.spec) for k, v in
                        jsh.batch_shardings(jcfg, jmesh, shapes).items()}
                got = {k: tuple(v) for k, v in tsh.batch_shardings(
                    tcfg, tmesh, _meta(shapes)).items()}
                assert got == want, (arch, b, got, want)


ZERO1_SHAPES = [(), (7,), (1 << 16,), (1 << 16 - 1,), (256, 256),
                (255, 257), (512, 128), (128, 512), (16, 4096),
                (4096, 16), (3, 64, 512), (64, 3, 512), (2, 2, 1 << 14),
                (48, 48, 48), (17, 4099), (2048, 151936), (151936, 2048)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero1_sharding_matches_jax(mesh):
    """Size floor, the largest divisible dimension (a tie to the lower
    index) and the axis fallbacks."""
    jmesh, tmesh = _meshes(mesh)
    for shape in ZERO1_SHAPES:
        s = jax.ShapeDtypeStruct(shape, "float32")
        want = tuple(jsh.zero1_sharding(jmesh, s).spec)
        got = tuple(tsh.zero1_sharding(tmesh, torch.empty(shape,
                                                          device="meta")))
        assert got == want, (shape, got, want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_tree_has_the_jax_packages_paths(arch):
    """The rules see the same leaves in both packages: the port's
    ``init_lm`` tree has the JAX package's key paths and shapes."""
    tcfg = smoke_config(arch)
    params = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    flat, _ = torch.utils._pytree.tree_flatten_with_path(params)
    got = {tsh._path_names(p): tuple(t.shape) for p, t in flat}
    want = {tsh._path_names(p): tuple(s.shape) for p, s in
            jax.tree_util.tree_leaves_with_path(_shapes(arch, "smoke"))}
    assert got == want


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except RuntimeError as e:
        return ("RuntimeError", str(e))


def test_plan_elastic_mesh_matches_jax():
    for n in (0, 1, 2, 3, 7, 8, 15, 16, 31, 64, 255, 256, 511, 512):
        for model in (1, 2, 4, 16):
            for batch in (1, 6, 8, 12, 256, 1000):
                for pods in (1, 2):
                    kind, want = _outcome(jft.plan_elastic_mesh, n, model,
                                          batch, pods)
                    got_kind, got = _outcome(tft.plan_elastic_mesh, n,
                                             model, batch, pods)
                    assert got_kind == kind
                    if kind == "ok":
                        assert (got.pod, got.data, got.model,
                                got.n_devices) == (
                            want.pod, want.data, want.model,
                            want.n_devices)
                    else:
                        assert got == want


def test_reassign_shards_matches_jax():
    for hosts in ([], [0], [3, 1, 2], [5, 0, 9, 7], list(range(16))):
        for n_shards in (0, 1, 5, 16, 33):
            assert _outcome(tft.reassign_shards, hosts, n_shards) == \
                _outcome(jft.reassign_shards, hosts, n_shards)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single_pod", "multi_pod"])
def test_make_production_mesh_needs_its_world(multi_pod):
    """The production meshes' shapes are the JAX package's; on a world of
    one they raise, naming the world size they need."""
    axes = production_axes(multi_pod=multi_pod)
    need = 512 if multi_pod else 256
    assert tuple(axes.values()) == ((2, 16, 16) if multi_pod else (16, 16))
    with pytest.raises(ValueError, match=f"{need} ranks"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_host_mesh_is_made_once():
    """``make_host_mesh`` reuses its mesh (a DeviceMesh makes a process
    group for each dimension)."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh("cpu")
    assert make_host_mesh("cpu") is mesh
    assert mesh.mesh_dim_names == ("data", "model")


def test_spec_is_a_partition_spec_tuple():
    """One-name tuples stored as the name, as ``PartitionSpec`` does; a
    spec is a tree leaf; the replicated spec is the empty one, as
    ``P()``."""
    from jax.sharding import PartitionSpec as P
    assert tuple(tsh.Spec(None, ("data",))) == tuple(P(None, ("data",)))
    assert tuple(tsh.Spec(("data", "model"))) == tuple(P(("data", "model")))
    assert torch.utils._pytree.tree_leaves(
        {"a": tsh.Spec(None, "data")}) == [tsh.Spec(None, "data")]
    assert tsh.Spec() == tuple(P()) == ()
