"""The port's gradient codecs, wire attacks, compressed aggregation and the
``signvote`` rule against ``repro.compress`` and ``repro.core.rules``.

Every input is a numpy draw from a seed, fed to both packages.  Payloads
and decodes are compared bit for bit, int8 with the reference's own
rounding noise fed through ``codecs.stochastic_rounding_noise``; top-k inputs
have no ties in magnitude.  Compressed trajectories run from the reference's
parameters and batches under deterministic attacks at rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiment as rexp
from repro.compress import pipeline as rpipe
from repro.compress.spec import CompressionSpec as RCompression
from repro.compress.spec import make_codec as rmake
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro_torch.compress import codecs as tcodecs
from repro_torch.compress import pipeline as tpipe
from repro_torch.compress.spec import CompressionSpec as TCompression
from repro_torch.compress.spec import available_codecs
from repro_torch.compress.spec import make_codec as tmake
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.attacks import AttackConfig as TAttack
from repro_torch.core.robust import RobustConfig as TRobust
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment import topologies as ttopo
from repro_torch.optim.optimizers import init_opt_state

KEY = jax.random.PRNGKey(3)
M, D = 8, 40
CODECS = ("dense", "topk", "signbit", "int8")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are tiny: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u(seed=0, m=M, d=D):
    u = np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)
    u[0, :3] = 0.0                      # exact zeros (signbit encodes +1)
    return u


def _codecs(name, ratio=0.2):
    return (rmake(RCompression(codec=name, ratio=ratio)),
            tmake(TCompression(codec=name, ratio=ratio)))


def _noise_feed(monkeypatch, key, shape):
    """Give the port's int8 codec the reference's uniform noise."""
    noise = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    monkeypatch.setattr(tcodecs, "stochastic_rounding_noise",
                        lambda gen, u: torch.tensor(noise))


def _eq(t, r):
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_registry_and_disabled_axis():
    assert set(available_codecs()) == {"dense", "topk", "signbit", "int8"}
    assert tmake(TCompression()) is None and tmake(None) is None
    for name in CODECS:
        r, t = _codecs(name)
        assert (t.stateful, t.payload_bytes(D)) == (r.stateful,
                                                   r.payload_bytes(D))


@pytest.mark.parametrize("name", CODECS)
def test_payload_and_decode_bit_for_bit(name, monkeypatch):
    u = _u(1)
    r, t = _codecs(name)
    rstate = r.init_state(M, D)
    tstate = t.init_state(M, D)
    if name == "topk":                  # a residual from an earlier step
        res = 0.1 * np.random.default_rng(2).standard_normal((M, D))
        rstate, tstate = jnp.asarray(res, jnp.float32), torch.tensor(
            res, dtype=torch.float32)
    _noise_feed(monkeypatch, KEY, (M, D))
    rp, rnew = r.encode(jnp.asarray(u), rstate, KEY)
    tp, tnew = t.encode(torch.tensor(u), tstate, torch.Generator())
    assert set(tp) == set(rp)
    for k in rp:
        assert str(tp[k].dtype).split(".")[-1] == str(rp[k].dtype), k
        _eq(tp[k], rp[k])
    _eq(tnew, rnew)
    _eq(t.decode(tp, D), r.decode(rp, D))


def test_topk_residual_conserves_mass():
    u = torch.tensor(_u(3))
    _, t = _codecs("topk", ratio=0.1)
    state = torch.tensor(_u(4)) * 0.01
    payload, new = t.encode(u, state, None)
    assert payload["idx"].shape == (M, 4)
    torch.testing.assert_close(t.decode(payload, D) + new, u + state,
                               rtol=0, atol=0)


def test_int8_error_is_under_one_step():
    u = torch.tensor(_u(5))
    _, t = _codecs("int8")
    out = tpipe.roundtrip_matrix(u, t, torch.Generator().manual_seed(0))
    step = u.abs().amax(dim=1, keepdim=True) / 127.0
    assert bool(((out - u).abs() <= step + 1e-6).all())


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("attack", ["bitplane_flip", "scale_inflate"])
def test_corrupt_payload_matches_reference(name, attack, monkeypatch):
    u = _u(6)
    r, t = _codecs(name)
    _noise_feed(monkeypatch, KEY, (M, D))
    rp, _ = r.encode(jnp.asarray(u), r.init_state(M, D), KEY)
    tp, _ = t.encode(torch.tensor(u), t.init_state(M, D), torch.Generator())
    racfg = AttackConfig(name=attack, num_byzantine=3)
    tacfg = TAttack(name=attack, num_byzantine=3)
    rc = rpipe.corrupt_payload(rp, attack, racfg)
    tc = tpipe.corrupt_payload(tp, attack, tacfg)
    for k in rc:
        _eq(tc[k], rc[k])
        _eq(tp[k], rp[k])                           # input left untouched
    with pytest.raises(ValueError, match="not an encoded-domain"):
        tpipe.corrupt_payload(tp, "signflip", tacfg)


def test_bytes_per_round_matches_reference():
    for name in CODECS:
        r, t = _codecs(name, ratio=0.05)
        for d, m, retries in ((118_282, 20, 0), (2_430_826, 16, 3)):
            assert tpipe.bytes_per_round(t, d, m, retries) == \
                rpipe.bytes_per_round(r, d, m, retries)


@pytest.mark.parametrize("rule,attack,codec", [
    ("phocas", "bitplane_flip", "topk"),
    ("trmean", "scale_inflate", "dense"),
    ("phocas", "signflip", "signbit"),
    ("signvote", "bitplane_flip", "signbit"),
    ("mean", "zero", "topk"),
])
def test_aggregate_compressed_matches_reference(rule, attack, codec):
    u = _u(7)
    r, t = _codecs(codec)
    rcfg = RobustConfig(rule=rule, b=2, q=2,
                        attack=AttackConfig(name=attack, num_byzantine=2))
    tcfg = TRobust(rule=rule, b=2, q=2,
                   attack=TAttack(name=attack, num_byzantine=2))
    active = np.ones(M, np.float32)
    active[5] = 0.0
    ragg, rsc, rnew = rpipe.aggregate_compressed(
        jnp.asarray(u), rcfg, r, r.init_state(M, D), KEY,
        active=jnp.asarray(active), with_scores=True)
    tagg, tsc, tnew = tpipe.aggregate_compressed(
        torch.tensor(u), tcfg, t, t.init_state(M, D), torch.Generator(),
        active=torch.tensor(active), with_scores=True)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(ragg), atol=1e-5)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(rsc), atol=1e-5)
    _eq(tnew, rnew)


# ---------------------------------------------------------------------------
# signvote
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [8, 9])
def test_signvote_is_the_references_exact_majority(m):
    u = np.round(np.random.default_rng(m).standard_normal((m, 64)), 1)
    u = u.astype(np.float32)                        # zeros and ties
    r = RobustConfig(rule="signvote").rule_obj()
    t = TRobust(rule="signvote").rule_obj()
    _eq(t.reduce(torch.tensor(u)), r.reduce(jnp.asarray(u)))
    _eq(t.reduce(torch.tensor(u)), np.sign(np.sign(u).sum(0)))
    ragg, rsc = r.reduce_with_scores(jnp.asarray(u))
    tagg, tsc = t.reduce_with_scores(torch.tensor(u))
    _eq(tagg, ragg)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(rsc), atol=1e-6)
    active = np.ones(m, np.float32)
    active[:2] = 0.0
    ragg, rsc = r.reduce_gated_with_scores(jnp.asarray(u),
                                           jnp.asarray(active))
    tagg, tsc = t.reduce_gated_with_scores(torch.tensor(u),
                                           torch.tensor(active))
    _eq(tagg, ragg)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(rsc), atol=1e-6)


def test_signvote_survives_a_bitplane_flip_minority():
    rng = np.random.default_rng(0)
    v = rng.standard_normal(40).astype(np.float32)
    u = torch.tensor(np.tile(v, (9, 1)) * np.abs(
        1.0 + 0.1 * rng.standard_normal((9, 40))).astype(np.float32))
    _, codec = _codecs("signbit")
    payload, _ = codec.encode(u, codec.init_state(9, 40), None)
    attacked = tpipe.corrupt_payload(
        payload, "bitplane_flip", TAttack(name="bitplane_flip",
                                          num_byzantine=3))
    got = TRobust(rule="signvote").rule_obj().reduce(
        codec.decode(attacked, 40))
    _eq(got, np.sign(v))


# ---------------------------------------------------------------------------
# compressed training, against the reference
# ---------------------------------------------------------------------------

def _spec(**kw):
    base = dict(
        name="compress-parity", model=rexp.ModelSpec(kind="mlp"),
        data=rexp.DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule="phocas", b=2, q=2),
        attack=AttackConfig(name="bitplane_flip", num_byzantine=2),
        compression=RCompression(codec="topk", ratio=0.05),
        num_workers=M, steps=4, log_every=1)
    base.update(kw)
    return rexp.ScenarioSpec(**base)


def _port_inputs(spec):
    plan = rexp.resolve(spec)
    init = jax.tree.map(np.asarray,
                        plan.model.init(jax.random.PRNGKey(spec.seed)))
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]
    tplan = tresolve(TSpec.from_json(spec.to_json()), device="cpu")
    tplan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                                "y": torch.tensor(batches[s]["y"]).long()}
    tplan.eval_fn = None
    params = params_from_numpy(init)
    return tplan, params


@pytest.mark.parametrize("overrides", [
    {},
    dict(attack=AttackConfig(name="signflip", num_byzantine=2)),
    dict(robust=RobustConfig(rule="signvote"),
         compression=RCompression(codec="signbit")),
    dict(robust=RobustConfig(rule="trmean", b=2),
         attack=AttackConfig(name="scale_inflate", num_byzantine=2),
         compression=RCompression(codec="dense")),
], ids=["topk-bitplane", "topk-signflip", "signbit-signvote",
        "dense-inflate"])
def test_compressed_sync_ps_matches_reference(overrides, tmp_path):
    rtel, ttel = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    spec = _spec(telemetry_path=rtel, **overrides)
    ref = rexp.run_experiment(spec)
    tplan, params = _port_inputs(spec)
    tplan.telemetry_path = ttel
    got = ttopo.SyncPS().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params)))
    np.testing.assert_allclose([r["loss"] for r in got.history],
                               [r["loss"] for r in ref.history], rtol=1e-4)
    for t, r in zip(jax.tree.leaves(params_to_numpy(got.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.params))):
        np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-6)
    from repro_torch.defense import read_jsonl
    wire = [{k: v for k, v in r.items() if k != "t"}
            for r in read_jsonl(ttel) if r["kind"] == "compress"]
    assert wire == [{k: v for k, v in r.items() if k != "t"}
                    for r in read_jsonl(rtel) if r["kind"] == "compress"]


def test_compressed_async_and_streaming_match_reference():
    from repro_torch.train import async_sgd
    spec = _spec(topology="async_ps", topology_params={"staleness": 1},
                 attack=AttackConfig(name="signflip", num_byzantine=2))
    ref = rexp.run_experiment(spec)
    tplan, params = _port_inputs(spec)
    init_fn, _ = async_sgd.make_async_train_step(
        tplan.model, robust_cfg=tplan.robust_cfg, opt_cfg=tplan.opt_cfg,
        acfg=async_sgd.AsyncConfig(num_workers=M),
        compress_cfg=tplan.compress_cfg)
    state = init_fn(torch.Generator())
    state["params"] = params
    state["worker_params"] = {
        k: {n: x.unsqueeze(0).repeat((M,) + (1,) * x.dim())
            for n, x in v.items()} for k, v in params.items()}
    got = ttopo.AsyncPS().run(tplan, init_state=state)
    for t, r in zip(jax.tree.leaves(params_to_numpy(got.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.params))):
        np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-6)

    spec = _spec(topology="streaming", compression=RCompression(
        codec="signbit"), attack=AttackConfig(name="zero", num_byzantine=2))
    ref = rexp.run_experiment(spec)
    tplan, params = _port_inputs(spec)
    got = ttopo.Streaming().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params)))
    np.testing.assert_allclose([r["loss"] for r in got.history],
                               [r["loss"] for r in ref.history], rtol=1e-4)
    for t, r in zip(jax.tree.leaves(params_to_numpy(got.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.params))):
        np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("topology", ["sync_ps", "async_ps", "streaming"])
def test_int8_trains_on_every_topology(topology):
    spec = TSpec.from_json(_spec(
        topology=topology, attack=AttackConfig(name="gaussian",
                                               num_byzantine=2),
        compression=RCompression(codec="int8"), steps=3).to_json())
    res = trun(spec, device="cpu")
    assert len(res.history) == 3
    assert all(torch.isfinite(x).all() for x in jax.tree.leaves(res.params))
