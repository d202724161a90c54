"""Serving and training on a (data, model) mesh with tensor-parallel compute,
in the port against the reference, on one gloo world of 4 CPU ranks.

One module-scoped spawn of a (2, 2) mesh (``torch_tp_ranks.py``) runs
every case.  Serving: ``generate`` and ``generate_stepwise`` on
granite-8b-reduced (B = 4, the batch sharded over the data axis, and
B = 3, replicated over it), gemma2-2b-reduced (windows, softcaps, the tied
table), a made-up 3-head x 8 config whose ``wq`` the model axis splits
mid-head, and deepseek-v2-lite-reduced (MLA and the MoE, whose data-shard
grouping takes the grouped branch in the prefill and the ungrouped one in
decode).  Tokens equal ``repro.serve.generate`` without a mesh (the
reference's own claim: a mesh does not change its tokens), the prefill's
and a decode step's logits within 1e-5; the MoE is held to the reference
with its ``data_axis_size`` monkeypatched to 2, the reference's grouped
semantics on one device.  Training: 3 ``sync_ps`` steps on gemma2-2b- and
deepseek-v2-lite-reduced from the reference's initial params on its
batches, against ``repro.experiment.run_experiment``'s local trajectory at
``test_torch_train.py``'s tolerances.  Every rank holds only its
``tree_pspecs`` blocks of params and optimizer state, counted in bytes.
Without a world, the port's ``moe_block`` under a pure data-2 mesh
description equals the monkeypatched reference's in both branches.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as r_moe
import repro.serve.engine as r_engine
from repro import experiment as rexp
from repro.configs import get_arch as r_arch
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.models import build_model as r_build
from repro.serve import generate as r_generate
from repro_torch import tree as tree_util
from repro_torch.configs import get_arch as t_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.dist.launch import spawn
from repro_torch.dist.mesh import use_mesh
from repro_torch.dist.sharding import Mesh, spec_leaves, tree_pspecs
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment.topologies import SyncPS
from repro_torch.models import moe as t_moe
from repro_torch.models.registry import build_model as t_build
from repro_torch.optim.optimizers import init_opt_state
from torch_tp_ranks import MESH, tp_rank

NEW = 4                                   # generated tokens a prompt
# case -> (arch, config changes, batch, prompt tokens, MoE grouping)
SERVE = {
    "granite B=4": ("granite-8b-reduced", {}, 4, 8, False),
    "granite B=3": ("granite-8b-reduced", {}, 3, 8, False),
    "gemma2": ("gemma2-2b-reduced", {}, 4, 8, False),
    "3 heads x 8": ("granite-8b-reduced",
                    dict(name="granite-3x8-reduced", num_heads=3,
                         num_kv_heads=1, head_dim=8), 2, 8, False),
    "deepseek": ("deepseek-v2-lite-16b-reduced", {}, 2, 8, True),
}
TRAIN = ("gemma2-2b-reduced", "deepseek-v2-lite-16b-reduced")
DESC = Mesh(("data", "model"), MESH)


def _port_params(arch, changes, seed=0):
    cfg = dataclasses.replace(t_arch(arch), **changes)
    return lm_params_to_numpy(
        t_build(cfg).init(torch.Generator().manual_seed(seed)))


def _prompts(arch, changes, batch, prompt_len):
    vocab = dataclasses.replace(r_arch(arch), **changes).vocab_size
    return np.random.default_rng(batch).integers(
        0, vocab, (batch, prompt_len)).astype(np.int32)


def _reference_serving(arch, changes, prompts, grouped, params):
    """The reference's tokens from ``generate`` without a mesh, and the
    logits of its prefill and of its first decode step (fed the first
    generated token), recorded from the steps ``generate`` makes."""
    rm = r_build(dataclasses.replace(r_arch(arch), **changes))
    logits = []
    real = r_engine.make_serve_step

    def recording(*args, **kw):
        step = real(*args, **kw)

        def recorded(*a):
            out = step(*a)
            logits.append(np.asarray(out[1]))
            return out
        return recorded

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_engine, "make_serve_step", recording)
        if grouped:
            mp.setattr(r_moe, "data_axis_size", lambda: MESH[0])
        toks = r_generate(rm, jax.tree.map(jnp.asarray, params),
                          jnp.asarray(prompts), NEW)
    return {"tokens": np.asarray(toks), "prefill": logits[0],
            "decode": logits[1]}


def _train_spec(arch, mesh=""):
    return rexp.ScenarioSpec(
        name=f"tp-{arch}",
        model=rexp.ModelSpec(kind="arch", arch=arch),
        data=rexp.DataSpec(kind="tokens", seq_len=8, batch_per_worker=2),
        robust=RobustConfig(rule="phocas", b=0),
        attack=AttackConfig(name="signflip", num_byzantine=1),
        num_workers=MESH[0], steps=3, log_every=1, mesh=mesh)


def _flat(leaves) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


def _local_port_run(rspec, init, batches) -> np.ndarray:
    """The port's single-process sync_ps run of ``rspec`` from ``init`` on
    ``batches``: its params."""
    plan = tresolve(TSpec.from_json(rspec.to_json()), device="cpu")
    feed = [{k: torch.tensor(v) for k, v in b.items()} for b in batches]
    plan.batch_fn = lambda s: feed[s]
    params = lm_params_from_numpy(init)
    res = SyncPS().run(plan, init_state=(
        params, init_opt_state(plan.opt_cfg, params)))
    return _flat(x.numpy() for x in tree_util.leaves(res.params))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's values and the (2, 2) world's, for every case: the
    inputs first, then the world runs in a thread while this process
    computes the reference's values."""
    serve_cases, train_cases, specs = {}, {}, {}
    for key, (arch, changes, batch, plen, _) in SERVE.items():
        serve_cases[key] = dict(
            arch=arch, changes=changes, params=_port_params(arch, changes),
            prompts=_prompts(arch, changes, batch, plen), new_tokens=NEW)
    for arch in TRAIN:
        rspec = specs[arch] = _train_spec(arch)
        plan = rexp.resolve(rspec)
        train_cases[arch] = dict(
            spec_json=_train_spec(arch, mesh="x".join(map(str, MESH)))
            .to_json(),
            init=jax.tree.map(np.asarray,
                              plan.model.init(jax.random.PRNGKey(rspec.seed))),
            batches=[jax.tree.map(np.asarray, plan.batch_fn(s))
                     for s in range(rspec.steps)],
            resume_dir=(str(tmp_path_factory.mktemp("tp"))
                        if arch == TRAIN[0] else None),
            cost_path=(str(tmp_path_factory.mktemp("cost") / "m.prom")
                       if arch == TRAIN[0] else None))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, tp_rank, MESH[0] * MESH[1], serve_cases,
                            train_cases)
        want = {key: _reference_serving(
            case["arch"], case["changes"], case["prompts"], SERVE[key][4],
            case["params"]) for key, case in serve_cases.items()}
        for arch, case in train_cases.items():
            ref = rexp.run_experiment(specs[arch])
            want[arch] = ([r["loss"] for r in ref.history],
                          _flat(jax.tree.leaves(ref.params)), case["init"],
                          _local_port_run(specs[arch], case["init"],
                                          case["batches"]))
        return want, ranks.result()


def _block_bytes(tree) -> int:
    """The bytes of one rank's ``tree_pspecs`` blocks of a whole numpy
    tree on the (2, 2) mesh: a model-sharded leaf's half, a replicated
    leaf whole."""
    total = 0
    for x, spec in zip(tree_util.leaves(tree),
                       spec_leaves(tree_pspecs(tree, DESC))):
        total += x.nbytes // (MESH[1] if any(spec) else 1)
    return total


@pytest.mark.parametrize("key", list(SERVE))
def test_mesh_serving_matches_the_reference(world, key):
    want, ranks = world
    got = ranks[0]["serve"][key]
    np.testing.assert_array_equal(got["tokens"], want[key]["tokens"])
    np.testing.assert_array_equal(got["stepwise"], want[key]["tokens"])
    np.testing.assert_allclose(got["prefill"], want[key]["prefill"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["decode"], want[key]["decode"],
                               rtol=0, atol=1e-5)
    assert got["batch_sharded"] == (SERVE[key][2] % MESH[0] == 0)


@pytest.mark.parametrize("key", list(SERVE))
def test_each_serving_rank_holds_only_its_blocks(world, key):
    _, ranks = world
    arch, changes = SERVE[key][:2]
    whole = _port_params(arch, changes)
    want = _block_bytes(whole)
    assert want < sum(x.nbytes for x in tree_util.leaves(whole))
    for r in ranks:
        assert r["serve"][key]["param_bytes"] == want


# Params against the reference's local run and the port's single-process
# run: test_torch_train.py's rtol 1e-4, atol 1e-6; deepseek at atol 1e-5,
# since the port's own single-process run of it is 1.07e-5 from the
# reference (24 of its 4,558,080 params past 1e-6 + 1e-4 |x|, XLA and
# PyTorch summing in other orders).  The mesh run's outliers are all in
# the embedding table, whose gradient carries the sqrt(d_model) = 45.3
# scale of the embedding: at most 2.0e-6 from the reference and 3.5e-6
# from the single-process run (sums split over the model ranks).
PARAM_ATOL = {"gemma2-2b-reduced": 1e-6,
              "deepseek-v2-lite-16b-reduced": 1e-5}


@pytest.mark.parametrize("arch", TRAIN)
def test_mesh_training_matches_the_reference_trajectory(world, arch):
    """Three sync_ps steps on the (2, 2) mesh (tensor-parallel compute),
    from the reference's params on its batches, against its local run and
    the port's single-process run."""
    want, ranks = world
    got = ranks[0]["train"][arch]
    assert got["tp"]
    losses, params, _, local = want[arch]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["params"], params, rtol=1e-4,
                               atol=PARAM_ATOL[arch])
    np.testing.assert_allclose(got["params"], local, rtol=1e-4,
                               atol=PARAM_ATOL[arch])


def test_mesh_resume_equals_the_uninterrupted_run(world):
    """Killed after its second step (a checkpoint every step: the blocks
    joined, rank 0 writing) and resumed (every rank reading the whole tree
    and cutting its blocks), the tensor-parallel run ends with the bits of
    the uninterrupted one."""
    _, ranks = world
    got = ranks[0]["train"][TRAIN[0]]
    assert got["resumed"].tobytes() == got["params"].tobytes()


def test_mesh_step_cost_leaves_the_run_alone(world):
    """With metrics on, every rank of the (2, 2) mesh counts the step once
    (an extra call through the model axis's collectives, under the
    counting modes); rank 0's snapshot has the count, and the run's
    losses and params are the bits of the run without it."""
    from repro_torch.obs import parse_exposition
    _, ranks = world
    got = ranks[0]["train"][TRAIN[0]]
    assert got["counted"]["losses"] == got["losses"]
    assert got["counted"]["params"].tobytes() == got["params"].tobytes()
    with open(got["counted"]["path"]) as fh:
        fams = parse_exposition(fh.read())
    for name in ("repro_step_flops", "repro_step_bytes"):
        assert fams[name]["samples"][0][2] > 0


@pytest.mark.parametrize("arch", TRAIN)
def test_each_training_rank_holds_only_its_blocks(world, arch):
    """After a mesh step each rank's params and momentum are its blocks:
    the replicated leaves whole, the model-sharded ones halved."""
    want, ranks = world
    init = want[arch][2]
    params = _block_bytes(init)
    mu = _block_bytes(jax.tree.map(lambda x: x.astype(np.float32), init))
    for r in ranks:
        assert r["train"][arch]["param_bytes"] == params
        assert r["train"][arch]["opt_bytes"] == mu


@pytest.mark.parametrize("shape,grouped", [((2, 8), True), ((2, 1), False)])
def test_grouped_moe_block_matches_the_reference(shape, grouped,
                                                 monkeypatch):
    """Without a world: the port's ``moe_block`` under a pure data-2 mesh
    description against the reference's with ``data_axis_size`` patched to
    2.  At k = 2 a (2, 8) input takes the grouped branch (capacity per
    group of 8 tokens, which changes the output here) and a (2, 1) decode
    the ungrouped one; ``no_data_grouping`` gives the ungrouped values."""
    arch = "deepseek-v2-lite-16b-reduced"
    cfg = dataclasses.replace(r_arch(arch), capacity_factor=1.0)
    tcfg = dataclasses.replace(t_arch(arch), capacity_factor=1.0)
    layer = _port_params(arch, {})["stack"]["blocks"]["l0"]["ffn"]
    layer = jax.tree.map(lambda x: x[0], layer)
    x = np.random.default_rng(5).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    rp = jax.tree.map(jnp.asarray, layer)
    # a jit each (a new function each, so neither reuses the other's
    # trace): the grouping is decided when the call is traced
    plain = jax.jit(lambda p, v: r_moe.moe_block(p, cfg, v))(
        rp, jnp.asarray(x))
    monkeypatch.setattr(r_moe, "data_axis_size", lambda: 2)
    r_out, r_aux = jax.jit(lambda p, v: r_moe.moe_block(p, cfg, v))(
        rp, jnp.asarray(x))
    tp = lm_params_from_numpy(layer)
    with use_mesh(Mesh(("data", "model"), (2, 1))):
        t_out, t_aux = t_moe.moe_block(tp, tcfg, torch.tensor(x))
        with t_moe.no_data_grouping():
            u_out, _ = t_moe.moe_block(tp, tcfg, torch.tensor(x))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), atol=1e-5)
    np.testing.assert_allclose(float(t_aux), float(r_aux), rtol=1e-5)
    np.testing.assert_allclose(u_out.numpy(), np.asarray(plain[0]),
                               atol=1e-5)
    assert grouped == (not np.allclose(np.asarray(r_out),
                                       np.asarray(plain[0]), atol=1e-4))
