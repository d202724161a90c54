"""``repro_torch.dist.sharding`` against ``repro.dist.sharding``, in one
process: the reference's rules read only a mesh's axis names and sizes, so a
``jax.sharding.AbstractMesh`` stands in for its devices.  Meshes: one device
(1, 1), (data, model) (4, 2), and (pod, data, model) (2, 4, 2)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.tree_util import DictKey

from repro.configs import get_arch as r_arch
from repro.dist import sharding as rsh
from repro.models import build_model as r_build
from repro_torch import tree as tree_util
from repro_torch.configs import get_arch as t_arch, list_archs
from repro_torch.dist import sharding as tsh
from repro_torch.models.registry import build_model as t_build

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4x2": ((2, 4, 2), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), tsh.Mesh(names, sizes)


def _spec(p) -> tuple:
    """A partition spec as a plain tuple of its entries."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def _leaf(shape):
    return jax.ShapeDtypeStruct(shape, "float32")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_axis_roles(name):
    rmesh, tmesh = _meshes(name)
    assert tsh.worker_axes_of(tmesh) == rsh.worker_axes_of(rmesh)
    assert tsh.model_axes_of(tmesh) == rsh.model_axes_of(rmesh)
    assert tmesh.shape == dict(rmesh.shape)
    assert tsh.MODEL_AXIS_NAMES == rsh.MODEL_AXIS_NAMES
    assert tsh.WORKER_AXIS_NAMES == rsh.WORKER_AXIS_NAMES


@pytest.mark.parametrize("arch", list_archs())
def test_tree_pspecs_of_every_family(arch):
    """Every leaf of each arch's reduced parameter tree, and of an
    optimizer-state copy of it, gets the reference's spec on each mesh; the
    spec tree mirrors the parameter tree, and a model-sharded dim divides."""
    want_tree = jax.eval_shape(r_build(r_arch(arch + "-reduced")).init,
                               jax.random.PRNGKey(0))
    got_tree = t_build(t_arch(arch + "-reduced")).init(
        torch.Generator().manual_seed(0))
    for name in MESHES:
        rmesh, tmesh = _meshes(name)
        want = jax.tree_util.tree_leaves_with_path(
            rsh.tree_pspecs({"mu": want_tree}, rmesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got_specs = tsh.tree_pspecs({"mu": got_tree}, tmesh)
        got = tsh.spec_leaves(got_specs)
        assert len(got) == len(want)
        shapes = [x.shape for x in tree_util.leaves({"mu": got_tree})]
        sharded = 0
        for (path, w), g, shape in zip(want, got, shapes):
            assert isinstance(g, tsh.P)
            assert _spec(g) == _spec(w), (name, path)
            for d, e in enumerate(g):
                if e is not None:
                    axes = (e,) if isinstance(e, str) else e
                    size = int(np.prod([tmesh.shape[a] for a in axes]))
                    assert shape[d] % size == 0
                    sharded += 1
        assert (sharded > 0) == (name != "1x1"), (arch, name)


def test_leaf_rule_override():
    """``leaf_rule`` wins when it returns a spec and falls through on
    None, as in the reference."""
    rmesh, tmesh = _meshes("4x2")
    tree = {"a": {"w": _leaf((4, 4))}, "b": {"w": _leaf((4, 4))}}
    want = rsh.tree_pspecs(
        tree, rmesh, leaf_rule=lambda n, leaf, m:
        jax.sharding.PartitionSpec(None, None) if n.startswith("a")
        else None)
    got = tsh.tree_pspecs(
        tree, tmesh, leaf_rule=lambda n, leaf, m:
        tsh.P(None, None) if n.startswith("a") else None)
    for k in ("a", "b"):
        assert _spec(got[k]["w"]) == _spec(want[k]["w"])
    assert got["a"]["w"] == tsh.P(None, None)
    assert got["b"]["w"] == tsh.P(None, "model")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_param_pspec_fsdp_and_its_fallbacks(name):
    """The joint group when it divides, then ever smaller groups, then
    replication."""
    rmesh, tmesh = _meshes(name)
    for shape in ((512, 24), (7, 24), (7, 5), (64, 48), (3, 8, 16), (),
                  (2,), (6, 4)):
        want = rsh.param_pspec_fsdp("x/w", _leaf(shape), rmesh)
        got = tsh.param_pspec_fsdp("x/w", _leaf(shape), tmesh)
        assert _spec(got) == _spec(want), (name, shape)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_cache_pspec(name):
    """Batch over the worker axes, GQA KV heads over the model axes, the
    scanned ``blocks`` subtree's leading period dim left alone."""
    rmesh, tmesh = _meshes(name)
    for path, shape in ((("tail0", "mixer", "k"), (16, 32, 4, 8)),
                        (("tail0", "mixer", "v"), (8, 16, 3, 8)),
                        (("blocks", "l0", "mixer", "k"), (2, 16, 32, 4, 8)),
                        (("blocks", "l0", "mixer", "latent"), (2, 8, 32, 64)),
                        (("tail0", "ssm", "state"), (8, 4, 16, 8)),
                        (("tail0", "mixer", "k"), (6, 32, 4, 8)),
                        (("pos",), (8,))):
        want = rsh.cache_pspec(tuple(DictKey(k) for k in path), _leaf(shape),
                               rmesh)
        got = tsh.cache_pspec(path, _leaf(shape), tmesh)
        assert _spec(got) == _spec(want), (name, path, shape)
