"""The port's checkpoints: the reference's on-disk format (a checkpoint
written by either package restores the other's ``params``/``opt`` bit for
bit), bf16 round trips, the ``.prev`` fall-back, and ``resume`` continuing a
killed ``sync_ps`` run bit for bit on the CPU, with random attacks, faults,
the defense and an error-feedback codec in the state.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as rio
from repro.models.mlp import build_mlp_model as rbuild
from repro.optim.optimizers import OptConfig as ROpt
from repro.optim.optimizers import init_opt_state as rinit_opt
from repro_torch.checkpoint import io as tio
from repro_torch.compress.spec import CompressionSpec
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.robust import RobustConfig
from repro_torch.defense import DefenseConfig
from repro_torch.experiment import DataSpec, ModelSpec, ScenarioSpec
from repro_torch.experiment import run_experiment as trun
from repro_torch.faults import FaultSpec
from repro_torch.models.mlp import build_mlp_model
from repro_torch.optim import OptConfig
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train.trainer import Trainer, TrainerConfig

CHAOS = (FaultSpec(kind="crash", workers=(4,), step=2),
         FaultSpec(kind="straggler", workers=(5,), delay_steps=2, jitter=1),
         FaultSpec(kind="flaky", workers=(6,), p_drop=0.3),
         FaultSpec(kind="pod", workers=(7,), inner=FaultSpec(kind="silent")))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are tiny: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            assert x == y and type(x) is type(y)


def test_round_trip_keeps_dtypes_bf16_and_ints(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn(3, 5, generator=gen),
                       "h": torch.randn(7, generator=gen).bfloat16()},
            "opt": {"step": 12},
            "defense": {"steps": torch.tensor(4, dtype=torch.int32),
                        "active": torch.ones(3)},
            "key": torch.Generator().manual_seed(5).get_state()}
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, tree, step=9)
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["dtypes"]["params/h"] == "bfloat16"
    assert meta["dtypes"]["opt/step"] == "int32"
    assert meta["keys"] == ["defense/active", "defense/steps", "key",
                            "opt/step", "params/h", "params/w"]
    like = {"params": {"w": torch.zeros(3, 5),
                       "h": torch.zeros(7, dtype=torch.bfloat16)},
            "opt": {"step": 0},
            "defense": {"steps": torch.tensor(0, dtype=torch.int32),
                        "active": torch.zeros(3)},
            "key": torch.Generator().get_state()}
    got, step = tio.load_checkpoint(path, like)
    assert step == 9
    _leaves_equal(got, tree)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint of the reference's MLP, written by
    ``repro.checkpoint.io``, restores the port's params and optimizer bit
    for bit; its JAX key is not the port's generator and is left alone."""
    model = rbuild(dims=(16, 32, 10))
    params = model.init(jax.random.PRNGKey(3))
    opt_cfg = ROpt(name="adam")
    opt = rinit_opt(opt_cfg, params)
    opt = {**opt, "step": jnp.asarray(7, jnp.int32),
           "mu": jax.tree.map(lambda x: x + 0.5, opt["mu"])}
    path = str(tmp_path / "ref")
    rio.save_checkpoint(path, {"params": params, "opt": opt,
                               "key": jax.random.PRNGKey(9)}, step=7)

    tparams = build_mlp_model(dims=(16, 32, 10)).init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    like = {"params": tparams,
            "opt": init_opt_state(OptConfig(name="adam"), tparams),
            "key": gen.get_state()}
    got, step, used_prev = tio.restore_checkpoint(
        path, like, optional=("key",), port_only=("key",))
    assert (step, used_prev) == (7, False)
    assert got["opt"]["step"] == 7
    assert torch.equal(got["key"], gen.get_state())
    for t, r in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    for t, r in zip(jax.tree.leaves(got["opt"]["mu"]),
                    jax.tree.leaves(opt["mu"])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    with pytest.raises(tio.CheckpointError, match="no valid checkpoint"):
        tio.restore_checkpoint(path, like, port_only=("key",))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tparams = build_mlp_model(dims=(16, 32, 10)).init(
        torch.Generator().manual_seed(0))
    path = str(tmp_path / "port")
    tio.save_checkpoint(path, {"params": tparams, "opt": {"step": 3}},
                        step=3)
    like = {"params": rbuild(dims=(16, 32, 10)).init(jax.random.PRNGKey(0)),
            "opt": {"step": jnp.asarray(0, jnp.int32)}}
    got, step = rio.load_checkpoint(path, like)
    assert step == 3 and int(got["opt"]["step"]) == 3
    for t, r in zip(jax.tree.leaves(tparams), jax.tree.leaves(got["params"])):
        np.testing.assert_array_equal(np.asarray(r), t.numpy())


def test_corrupt_newest_falls_back_to_prev(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"params": {"w": torch.arange(4, dtype=torch.float32)},
            "opt": {"step": 0}}
    tio.save_checkpoint(path, tree, step=5)
    tio.save_checkpoint(path, {"params": {"w": tree["params"]["w"] + 1},
                               "opt": {"step": 1}}, step=10)
    got, step, used_prev = tio.restore_checkpoint(path, tree)
    assert (step, used_prev) == (10, False)
    with open(path + ".npz", "r+b") as f:            # bit-rot the newest
        f.seek(30)
        f.write(b"\xff" * 8)
    with pytest.raises(tio.CheckpointError, match="checksum"):
        tio.load_checkpoint(path, tree)
    got, step, used_prev = tio.restore_checkpoint(path, tree)
    assert (step, used_prev) == (5, True)
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    with open(path + ".prev.npz", "r+b") as f:       # truncate the other
        f.truncate(20)
    with pytest.raises(tio.CheckpointError, match="nor its .prev"):
        tio.restore_checkpoint(path, tree)


def _spec(tmp_path, name, **kw):
    base = dict(
        name="resume-t", model=ModelSpec(kind="mlp"),
        data=DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule="phocas", b=2, q=2),
        attack=AttackConfig(name="gaussian", num_byzantine=2),
        num_workers=8, steps=10, log_every=1,
        checkpoint_path=str(tmp_path / name), checkpoint_every=5)
    base.update(kw)
    return ScenarioSpec(**base)


@pytest.mark.parametrize("axes", [
    dict(defense=DefenseConfig(), faults=CHAOS),
    dict(defense=DefenseConfig(adapt_b=True, adapt_patience=1),
         robust=RobustConfig(rule="phocas", b=1, q=1),
         attack=AttackConfig(name="gaussian", num_byzantine=3),
         compression=CompressionSpec(codec="topk", ratio=0.1)),
], ids=["defense-chaos", "adapt_b-topk"])
def test_kill_and_resume_is_bit_for_bit(axes, tmp_path):
    full = trun(_spec(tmp_path, "full", **axes), device="cpu")
    partial = _spec(tmp_path, "ck", steps=6, **axes)   # dies after step 5
    trun(partial, device="cpu")
    resumed = trun(dataclasses.replace(partial, steps=10), device="cpu",
                   resume=partial.checkpoint_path)
    _leaves_equal(resumed.params, full.params)
    _leaves_equal(resumed.defense_state, full.defense_state)
    assert resumed.robust_cfg == full.robust_cfg
    np.testing.assert_array_equal(
        [r["loss"] for r in resumed.history if "loss" in r],
        [r["loss"] for r in full.history if "loss" in r and r["step"] > 5])


def test_trainer_shim_checkpoints_and_restores(tmp_path):
    from repro_torch.data.pipeline import ClassificationData
    data = ClassificationData(dim=16, seed=0)
    path = str(tmp_path / "trainer")
    tcfg = TrainerConfig(num_workers=8, steps=6, log_every=2,
                         checkpoint_path=path, checkpoint_every=5)
    trainer = Trainer(build_mlp_model(dims=(16, 32, 10)),
                      lambda s: data.batch(s, 32), tcfg,
                      RobustConfig(rule="trmean", b=2), OptConfig(lr=0.1),
                      defense_cfg=DefenseConfig(), device="cpu")
    hist = trainer.run()
    assert [r["step"] for r in hist] == [0, 2, 4, 5]
    other = Trainer(build_mlp_model(dims=(16, 32, 10)),
                    lambda s: data.batch(s, 32), tcfg,
                    RobustConfig(rule="trmean", b=2), OptConfig(lr=0.1),
                    defense_cfg=DefenseConfig(), device="cpu")
    assert other.restore(path) == 5
    _leaves_equal(other.params, trainer.params)
    _leaves_equal(other.defense_state, trainer.defense_state)
