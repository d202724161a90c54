"""The distributed engine of repro_torch against the reference, on gloo
worlds of CPU processes.

Three spawns in all.  One 4-rank world, spawned in a thread while this
process computes the reference's values, first builds the (4, 1), (2, 2)
and joint (pod, data) (2, 2, 1) meshes and runs every registered rule in
both layouts,
with and without scores and the gate, under the deterministic attacks; the
expected value is the reference's LOCAL path
(``repro.core.robust.aggregate_matrix``) on the zero-padded matrix attacked
by ``repro.core.attacks.make_attack`` as each layout attacks it: whole, or
slice by slice in the sharded layout (the identity the reference's own
DIST_EQUIV/MULTIPOD tests assert), at the reference's tolerance
(``np.allclose(..., atol=1e-4)``), the trim family's summed drop counts
equal as integers.  On the (2, 2) mesh the model axis splits each worker's
leaves on their last dim, as the train step splits a model-sharded leaf, so
each model rank attacks and aggregates its block.  One 6-rank (3, 2) world
shows the reference-side fact that a replicated leaf is counted on every
model rank.
The same 4-rank world then runs ``run_experiment`` as its ranks (training
on "4x1" and "2x2" against the single-process run, and, started from the
reference's params on its batches, against the reference's local sync_ps
trajectory; a defended run, resume, a mesh the world does not fit); one
``run_experiment`` call from this process spawns its own ranks.  The spec and step refusals for a mesh are the
reference's.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiment as rexp
from repro.core import selection as rsel
from repro.core.attacks import AttackConfig as RAttack, make_attack
from repro.core.registry import available_rules as r_available_rules
from repro.core.robust import RobustConfig as RConfig
from repro.core.robust import aggregate_matrix as r_aggregate
from repro.experiment import ScenarioSpec as RSpec
from repro.experiment import SpecError as RSpecError
from repro_torch.compress.spec import CompressionSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core.aggregators import krum_scores
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.registry import available_rules, distance_ratio_scores
from repro_torch.core.robust import RobustConfig
from repro_torch.defense import DefenseConfig, read_jsonl
from repro_torch.dist.launch import spawn
from repro_torch.dist.mesh import HostMesh
from repro_torch.experiment import (DataSpec, ModelSpec, ScenarioSpec,
                                    SpecError, run_experiment)
from repro_torch.models.mlp import build_mlp_model
from repro_torch.optim import OptConfig
from repro_torch.train.step import make_train_step
from torch_dist_ranks import mesh4_rank, replicated_leaf_rank

# Per worker: b (2,) + w (3, 5) at m = 4 (17 coordinates, padded to 20);
# w (2, 8) at m = 2, whose last dim the (2, 2) mesh's model axis splits.
SHAPES = {4: {"b": (2,), "w": (3, 5)}, 2: {"w": (2, 8)}}
ATTACKS = ("signflip", "zero", "omniscient", "bitflip")
ACTIVE = {4: [1.0, 1.0, 0.0, 1.0], 2: [1.0, 0.0]}
TP = {"4x1": 1, "2x2": 2, "2x2x1": 1}


def _inputs(m: int) -> dict:
    """The worker trees, from a seed: rows near 1 with worker 0 scaled by
    30, as the reference's layout test."""
    rng = np.random.default_rng(m)
    out = {}
    for k in sorted(SHAPES[m]):
        x = (1.0 + 0.1 * rng.standard_normal((m, *SHAPES[m][k])))
        x[0] *= 30.0
        out[k] = x.astype(np.float32)
    return out


def _blocks(m: int, tp: int) -> list:
    """Column indices of the (m, D) ravel-order matrix that each model rank
    holds, in its local order: each leaf's block of its last dim."""
    start, blocks = 0, [[] for _ in range(tp)]
    for k in sorted(SHAPES[m]):
        idx = np.arange(int(np.prod(SHAPES[m][k]))).reshape(SHAPES[m][k])
        for b, part in enumerate(np.split(idx, tp, axis=-1)):
            blocks[b].extend((start + part).reshape(-1))
        start += idx.size
    return blocks


def _attack(name: str, m: int) -> dict:
    """A deterministic attack: q = 2 of 4 (1 of 2) rows; bitflip hits every
    row of the first 2 coordinates of the matrix, or of each slice."""
    if name == "bitflip":
        return dict(name=name, num_byzantine=m, bitflip_dims=2)
    return dict(name=name, num_byzantine=m // 2)


def _cases():
    """Every rule x layout x with_scores x active on each mesh; the attack
    turns through ATTACKS with the (rule, with_scores, active) index."""
    cases = []
    for mesh, m in (("4x1", 4), ("2x2", 2), ("2x2x1", 4)):
        for i, rule in enumerate(available_rules()):
            if m < 4 and rule in ("krum", "multikrum"):
                continue            # Krum needs m - q - 2 > 0
            for j, (ws, act) in enumerate(
                    [(ws, act) for ws in (False, True)
                     for act in (None, ACTIVE[m])]):
                attack = _attack(ATTACKS[(4 * i + j) % 4], m)
                for layout in ("replicated", "sharded"):
                    cases.append(dict(
                        key=(mesh, rule, layout, ws, act is not None),
                        mesh=mesh, m=m, rule=rule, layout=layout,
                        with_scores=ws, active=act, attack=attack,
                        b=1 if m == 4 else 0, q=1 if m == 4 else 0))
    return cases


def _matrix(m: int) -> np.ndarray:
    tree = _inputs(m)
    return np.concatenate([tree[k].reshape(m, -1) for k in sorted(tree)], 1)


def _padded(m: int) -> np.ndarray:
    mat = _matrix(m)
    return np.pad(mat, ((0, 0), (0, (-mat.shape[1]) % m)))


_EXPECTED: dict = {}


def _expected(case):
    """The reference's local path on the matrix as the mesh attacks it:
    each model rank's block, zero-padded to a multiple of m, attacked whole
    (replicated) or slice by slice (sharded); the aggregate comes back in
    ravel order, without the padding."""
    m, atk, tp = case["m"], case["attack"], TP[case["mesh"]]
    # Only bitflip attacks a slice otherwise than the whole matrix.
    sliced = case["layout"] == "sharded" and atk["name"] == "bitflip"
    key = (m, tp, sliced, case["rule"], case["with_scores"],
           case["active"] is not None, atk["name"])
    if key not in _EXPECTED:
        full = _matrix(m)
        attack = make_attack(RAttack(**atk))
        k = jax.random.PRNGKey(0)
        pieces, cols = [], []
        for idx in _blocks(m, tp):
            block = np.pad(full[:, idx], ((0, 0), (0, (-len(idx)) % m)))
            parts = np.split(block, m, axis=1) if sliced else [block]
            pieces += [np.asarray(attack(k, jnp.asarray(p), None))
                       for p in parts]
            cols += list(idx) + [-1] * (block.shape[1] - len(idx))
        active = (None if case["active"] is None
                  else jnp.asarray(case["active"]))
        out = r_aggregate(jnp.asarray(np.concatenate(pieces, 1)),
                          RConfig(rule=case["rule"], b=case["b"],
                                  q=case["q"]),
                          active=active, with_scores=case["with_scores"])
        agg, scores = out if case["with_scores"] else (out, None)
        cols = np.asarray(cols)
        ravel = np.empty(full.shape[1], np.float32)
        ravel[cols[cols >= 0]] = np.asarray(agg)[cols >= 0]
        _EXPECTED[key] = (ravel,
                          None if scores is None else np.asarray(scores))
    return _EXPECTED[key]


def _gathered(ranks, case) -> np.ndarray:
    """Rank 0's aggregate, its model blocks joined on each leaf's last dim
    (ranks 0..tp-1 hold worker 0's blocks), in ravel order."""
    tp = TP[case["mesh"]]
    trees = [ranks[r]["cases"][case["key"]][0] for r in range(tp)]
    return np.concatenate([np.concatenate([t[k] for t in trees], -1)
                           .reshape(-1) for k in sorted(trees[0])])


@pytest.fixture(scope="module")
def layouts(world4):
    return world4["cases"], [r["layouts"] for r in world4["ranks"]]


def _close(got, want) -> bool:
    return bool(np.allclose(got, want, atol=1e-4, equal_nan=True))


def test_every_rule_in_both_layouts_matches_the_local_path(layouts):
    cases, ranks = layouts
    assert available_rules() == r_available_rules()
    assert len(cases) == 2 * 4 * (2 * len(available_rules())
                                  + len(available_rules()) - 2)
    bad = []
    for case in cases:
        scores = ranks[0]["cases"][case["key"]][1]
        want_agg, want_scores = _expected(case)
        ok = _close(_gathered(ranks, case), want_agg)
        if case["with_scores"]:
            ok = ok and _close(scores, want_scores)
        if not ok:
            bad.append((case["key"], case["attack"]["name"]))
    assert not bad, bad


def test_every_rank_ends_with_the_same_bits(layouts):
    """Every rank of a model rank's line holds the same aggregate block,
    and every rank the same scores."""
    _, ranks = layouts
    for key, (_, scores0) in ranks[0]["cases"].items():
        tp = TP[key[0]]
        for r, rank in enumerate(ranks):
            agg, scores = rank["cases"][key]
            same = ranks[r % tp]["cases"][key][0]
            assert all(agg[k].tobytes() == same[k].tobytes() for k in agg)
            if scores is not None:
                assert scores.tobytes() == scores0.tobytes(), key


@pytest.mark.parametrize("rule", ["trmean", "phocas", "mediam"])
def test_summed_drop_counts_are_the_local_integers(layouts, rule):
    """The sharded layout's drop counts, summed over the worker axes (one
    and two of them), equal the reference's counts on the whole padded
    matrix as integers; the coordinate total counts the padding."""
    _, ranks = layouts
    _, want, ncoords = rsel.trim_family(jnp.asarray(_padded(4)), 1, rule,
                                        with_scores=True)
    for mesh in ("4x1", "2x2x1"):
        for r in ranks:
            counts, n = r["counts"][(mesh, rule)]
            np.testing.assert_array_equal(counts, np.asarray(want))
            assert n == float(ncoords) == 20.0


def test_replicated_leaf_is_summed_on_every_model_rank():
    """On a (3, 2) mesh the train step's local tree holds the block of a
    model-sharded leaf and the whole of a replicated one, so Krum's
    distances summed over the model axis count the replicated leaf twice,
    as the reference's do: the scores are those of the matrix with that
    leaf repeated, not of the plain matrix (ROADMAP queue 3)."""
    rng = np.random.default_rng(7)
    leaves = {"w": rng.standard_normal((3, 4, 6)).astype(np.float32),
              "scale": (3.0 * rng.standard_normal((3, 6))).astype(
                  np.float32)}
    ranks = spawn(replicated_leaf_rank, 6, leaves)
    w = torch.tensor(leaves["w"]).reshape(3, -1)
    s = torch.tensor(leaves["scale"])
    twice = distance_ratio_scores(krum_scores(torch.cat([w, s, s], 1), 0))
    once = distance_ratio_scores(krum_scores(torch.cat([w, s], 1), 0))
    assert not torch.allclose(twice, once, atol=1e-3)
    for scores in ranks:
        np.testing.assert_allclose(scores, twice.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _mlp_spec(mesh: str, m: int, **kw):
    base = dict(
        name=f"mesh-{mesh or 'local'}",
        model=ModelSpec(kind="mlp", dims=(16, 16, 10)),
        data=DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule="phocas", b=1 if m == 4 else 0),
        attack=AttackConfig(name="signflip", num_byzantine=1),
        opt=OptConfig(name="sgd", lr=0.1), num_workers=m, steps=3,
        log_every=1, mesh=mesh)
    base.update(kw)
    return ScenarioSpec(**base)


def _specs(tmp):
    defended = dict(defense=DefenseConfig(reputation_decay=0.6,
                                          warmup_steps=1), steps=8,
                    telemetry_path=str(tmp / "defended.jsonl"))
    return {
        "4x1/sharded": _mlp_spec("4x1", 4),
        "4x1/replicated": _mlp_spec(
            "4x1", 4, robust=RobustConfig(rule="phocas", b=1,
                                          layout="replicated")),
        "2x2/sharded": _mlp_spec("2x2", 2),
        "4x1/defended": _mlp_spec("4x1", 4, **defended),
    }


# The mesh runs that also start from the reference's own params and
# batches, to be held to its local sync_ps trajectory.
FROM_REFERENCE = {"4x1/sharded": ("4x1", 4), "2x2/sharded": ("2x2", 2)}


def _reference_starts() -> dict:
    """name -> (spec, the reference's initial params and batches as numpy,
    the reference's spec with no mesh)."""
    out = {}
    for name, (mesh, m) in FROM_REFERENCE.items():
        spec = _mlp_spec(mesh, m)
        rspec = RSpec.from_dict({**spec.to_dict(), "mesh": ""})
        plan = rexp.resolve(rspec)
        init = jax.tree.map(np.asarray,
                            plan.model.init(jax.random.PRNGKey(rspec.seed)))
        batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
                   for s in range(rspec.steps)]
        out[name] = (spec, init, batches, rspec)
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The 4-rank world's layout cases and training runs, spawned in a
    thread while this process computes the reference's values (each
    layout case's local-path result and the reference's local runs)."""
    cases = _cases()
    inputs = {m: _inputs(m) for m in (4, 2)}
    tmp = tmp_path_factory.mktemp("mesh")
    resume = _mlp_spec("4x1", 4, steps=4, checkpoint_every=2,
                       checkpoint_path=str(tmp / "ck.pt"),
                       attack=AttackConfig(name="gaussian", num_byzantine=1))
    starts = _reference_starts()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, mesh4_rank, 4, (cases, inputs),
                            (_specs(tmp), resume,
                             {k: v[:3] for k, v in starts.items()}))
        for case in cases:
            _expected(case)
        runs = {k: v[:3] + (rexp.run_experiment(v[3]),)
                for k, v in starts.items()}
        return {"cases": cases, "tmp": tmp, "ranks": ranks.result(),
                "reference_runs": runs}


@pytest.fixture(scope="module")
def reference_runs(world4):
    """name -> (spec, the reference's initial params and batches as numpy,
    the reference's local run of the spec with no mesh)."""
    return world4["reference_runs"]


@pytest.fixture(scope="module")
def training(world4):
    return world4["tmp"], [r["training"] for r in world4["ranks"]]


def _local(spec):
    return run_experiment(dataclasses.replace(spec, mesh="",
                                              telemetry_path=""),
                          device="cpu")


def _flat(params):
    from repro_torch import tree as tree_util
    return np.concatenate([x.numpy().reshape(-1)
                           for x in tree_util.leaves(params)])


@pytest.mark.parametrize("name", ["4x1/sharded", "4x1/replicated",
                                  "2x2/sharded", "4x1/defended"])
def test_mesh_training_matches_the_single_process_run(training, name):
    tmp, ranks = training
    spec = _specs(tmp)[name]
    want = _local(spec)
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"],
                               [r["loss"] for r in want.history],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["params"], _flat(want.params),
                               rtol=1e-4, atol=1e-5)
    for r in ranks[1:]:
        assert r[name]["params"].tobytes() == got["params"].tobytes()
        assert r[name]["losses"] == got["losses"]
    if spec.defense is not None:
        np.testing.assert_array_equal(got["active"],
                                      want.defense_state["active"].numpy())
        assert got["active"][0] == 0      # the Byzantine worker is ejected
        # rank 0 alone wrote the telemetry: one record a step
        recs = [r for r in read_jsonl(spec.telemetry_path)
                if r["kind"] == "train"]
        assert [r["step"] for r in recs] == list(range(spec.steps))


@pytest.mark.parametrize("name", list(FROM_REFERENCE))
def test_mesh_training_matches_the_reference_trajectory(
        training, reference_runs, name):
    """The mesh step (each rank's batch row, the loss all_gather, the
    model axis's blocks on "2x2") started from the reference's params on
    its batches, against the reference's local sync_ps run under signflip,
    at ``test_torch_train.py``'s tolerances."""
    _, ranks = training
    ref = reference_runs[name][3]
    got = ranks[0]["from_reference"][name]
    np.testing.assert_allclose(got["losses"],
                               [r["loss"] for r in ref.history], rtol=1e-4)
    want = _flat(params_from_numpy(jax.tree.map(np.asarray, ref.params)))
    np.testing.assert_allclose(got["params"], want, rtol=1e-4, atol=1e-6)
    for r in ranks[1:]:
        assert r["from_reference"][name]["params"].tobytes() == \
            got["params"].tobytes()


def test_mesh_resume_equals_the_uninterrupted_run(training):
    _, ranks = training
    for r in ranks:
        whole, resumed = r["resume"]
        assert resumed["params"].tobytes() == whole["params"].tobytes()
        assert resumed["losses"] == whole["losses"][-1:]


def test_a_world_the_mesh_does_not_fit_raises(training):
    _, ranks = training
    for r in ranks:
        assert "needs 8 ranks, the world has 4" in r["misfit"]


def test_run_experiment_spawns_its_own_ranks(training):
    """From a process with no world, ``run_experiment`` spawns the ranks
    and returns rank 0's result: the same bits as a rank of a world made
    beforehand."""
    tmp, ranks = training
    res = run_experiment(_specs(tmp)["4x1/sharded"], device="cpu")
    assert [r["loss"] for r in res.history] == \
        ranks[0]["4x1/sharded"]["losses"]
    assert _flat(res.params).tobytes() == \
        ranks[0]["4x1/sharded"]["params"].tobytes()


@pytest.mark.parametrize("overrides,match", [
    (dict(faults=[dict(kind="crash", workers=[1])]),
     "faults model whole-worker absence"),
    (dict(compression=dict(codec="int8")),
     "compression encodes each worker's full gradient row"),
    (dict(mesh="2x2"), "has a data axis of 2 but num_workers=4"),
    (dict(mesh="4by2"), "mesh must look like"),
    (dict(topology="streaming"), "does not support a device mesh"),
])
def test_mesh_spec_refusals_are_the_reference(overrides, match):
    """Each refusal raises the reference's SpecError before any rank is
    spawned; both packages read the same JSON."""
    d = {**_mlp_spec("4x1", 4).to_dict(), **overrides}
    with pytest.raises(RSpecError, match=match):
        RSpec.from_dict(d).validate()
    with pytest.raises(SpecError, match=match):
        run_experiment(ScenarioSpec.from_dict(d), device="cpu")


def test_mesh_train_step_refusals():
    """``make_train_step`` on a mesh refuses compression and a worker count
    other than the mesh's worker axes, as the reference's does."""
    mesh = HostMesh(axis_names=("data", "model"), axis_sizes=(4, 1),
                    coords=(0, 0))
    model = build_mlp_model(dims=(16, 16, 10))
    kw = dict(robust_cfg=RobustConfig(), opt_cfg=OptConfig(), mesh=mesh)
    with pytest.raises(ValueError, match="gradient compression"):
        make_train_step(model, num_workers=4,
                        compress_cfg=CompressionSpec(codec="int8"), **kw)
    with pytest.raises(ValueError, match="num_workers=8 != mesh worker"):
        make_train_step(model, num_workers=8, **kw)
