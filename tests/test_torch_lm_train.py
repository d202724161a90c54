"""LM training on the token stream in the port against the reference, CPU.

Both packages get the same numpy inputs: one set of initial parameters goes
to the reference as arrays and to the port through ``lm_params_from_numpy``,
and the reference's token batches are fed to the port (torch cannot draw
``jax.random``'s tokens).  At f32, per-worker
losses agree within 1e-5 and gradients within atol 1e-4 + rtol 1e-3 (XLA
and PyTorch sum the products in other orders); a 3-step ``sync_ps`` run
under signflip and omniscient keeps the losses within rtol 1e-5 and each
step's parameters within atol 1e-4 of the reference's, but for Phocas's
distance near-ties (``TIE_GAP``).  The
remat policies "none", "full" and "dots" give equal losses and gradients
(bit for bit: the recompute runs the same operations on the same inputs).
The other topologies, faults and compression train an arch model for two
steps with finite losses; one streaming step equals one step of the batch
rule within atol 2e-5, as ``test_torch_streaming.py`` holds the MLP.  The
built-in attacks write into the engine's matrix with the values of their
copying call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiment as rexp
from repro.configs import get_arch as r_arch
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.data.pipeline import make_worker_batches as r_worker_batches
from repro.models import build_model as r_build
from repro.optim import init_opt_state as r_init_opt_state
from repro.train.step import make_train_step as r_make_train_step
from repro_torch import tree as tree_util
from repro_torch.configs import get_arch as t_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.core import robust as trobust
from repro_torch.core.robust import flatten_stacked
from repro_torch.data.pipeline import TokenStream, make_worker_batches
from repro_torch.experiment import ScenarioSpec as TSpec
from repro_torch.experiment import resolve as tresolve
from repro_torch.experiment import run_experiment as trun
from repro_torch.experiment.topologies import SyncPS
from repro_torch.models import common as C
from repro_torch.models.registry import build_model as t_build
from repro_torch.kernels.trmean.ref import trmean_ref
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train.step import make_train_step as t_make_train_step

M, B, S = 4, 2, 16
# Phocas's boundary distance gap below which the two packages may select
# differently: 4x the largest gradient difference measured between them on
# gemma2-2b-reduced (4.8e-7).
TIE_GAP = 2e-6


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _worker_batch(vocab, seed=0):
    return {"tokens": _tokens(seed, (M, B, S), vocab),
            "labels": _tokens(seed + 1, (M, B, S), vocab)}


def _port_grads(model, params, batch):
    """The train step's per-worker expression (``train/step.py``)."""
    fn = torch.func.vmap(torch.func.grad_and_value(model.loss),
                         in_dims=(None, 0))
    return fn(params, {k: torch.tensor(v) for k, v in batch.items()})


def test_token_stream_shapes_shift_and_determinism():
    ts = TokenStream(vocab_size=50_000, seq_len=12, global_batch=6, seed=3)
    a, b = ts.batch(5), ts.batch(5)
    assert a["tokens"].shape == a["labels"].shape == (6, 12)
    assert a["tokens"].dtype == torch.int32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a["tokens"], ts.batch(6)["tokens"])
    # labels are the sequence shifted by one
    torch.testing.assert_close(a["labels"][:, :-1], a["tokens"][:, 1:],
                               rtol=0, atol=0)
    # tokens within the active vocab min(V, 4096)
    assert int(a["tokens"].max()) < 4096 and int(a["tokens"].min()) >= 0
    small = TokenStream(vocab_size=100, seq_len=8, global_batch=4, seed=3)
    assert int(small.batch(0)["labels"].max()) < 100
    other = TokenStream(vocab_size=50_000, seq_len=12, global_batch=6, seed=4)
    assert not torch.equal(other.batch(5)["tokens"], a["tokens"])


def _lm_spec_ref(attack="signflip"):
    return rexp.ScenarioSpec(
        name=f"lm-{attack}",
        model=rexp.ModelSpec(kind="arch", arch="gemma2-2b-reduced"),
        data=rexp.DataSpec(kind="tokens", seq_len=S, batch_per_worker=B),
        robust=RobustConfig(rule="phocas", b=1, q=1),
        attack=AttackConfig(name=attack, num_byzantine=1),
        num_workers=M, steps=3, log_every=1)


def _numpy_params(name, seed=0):
    """Initial parameters both packages start from, as numpy (the port's
    draw: the reference's would cost a compile per arch)."""
    return lm_params_to_numpy(
        t_build(t_arch(name)).init(torch.Generator().manual_seed(seed)))


@pytest.fixture(scope="module")
def reference():
    """Per arch, the reference's model and the numpy initial parameters;
    the reference token stream's batches of the trajectory spec, drawn once
    (one jitted draw) for every test."""
    out = {name: (r_build(r_arch(name)), _numpy_params(name))
           for name in ("gemma2-2b-reduced", "granite-8b-reduced")}
    draw = jax.jit(rexp.resolve(_lm_spec_ref()).batch_fn)
    out["batches"] = [draw(s) for s in range(3)]
    return out


@pytest.mark.parametrize("name", ["gemma2-2b-reduced", "granite-8b-reduced"])
def test_per_worker_losses_and_grads_match_reference(name, reference):
    rm, init = reference[name]
    tm = t_build(t_arch(name))
    rp, tp = jax.tree.map(jnp.asarray, init), lm_params_from_numpy(init)
    batch = _worker_batch(r_arch(name).vocab_size)
    r_loss, r_grads = jax.jit(jax.vmap(jax.value_and_grad(rm.loss),
                                       in_axes=(None, 0)))(
        rp, jax.tree.map(jnp.asarray, batch))
    t_grads, t_loss = _port_grads(tm, tp, batch)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(r_loss),
                               rtol=0, atol=1e-5)
    got = tree_util.leaves(lm_params_to_numpy(t_grads))
    want = jax.tree.leaves(r_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-3)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("attack", ["signflip", "omniscient"])
def test_sync_ps_trajectory_matches_reference(attack, reference,
                                              monkeypatch):
    """Three sync_ps steps from the same parameters on the reference's
    batches.  The reference's trajectory is its train step (the one its
    sync_ps loop calls) stepped three times; the port's sync_ps loop runs
    the same steps, losses within rtol 1e-5.  Step by step, the port's
    train step from the reference's parameters of each step gives the
    reference's next parameters within 1e-4, except where Phocas's
    selection sat at a near-tie in that step's worker matrix: a gap below
    ``TIE_GAP`` between the (m-b)-th and (m-b+1)-th distance from the
    trimmed mean, where the two packages' gradients, 4.8e-7 apart, pick
    either worker.  After such a flip the two runs' parameters part
    (signflip makes near-ties: 3 of 1,313,024 coordinates at step 0), so
    the whole run is held on its parameters only under omniscient, whose
    Byzantine row is always the one dropped."""
    spec = _lm_spec_ref(attack)
    plan = rexp.resolve(spec)
    init, batches = reference["gemma2-2b-reduced"][1], reference["batches"]
    r_step = r_make_train_step(plan.model, robust_cfg=plan.robust_cfg,
                               opt_cfg=plan.opt_cfg, num_workers=M,
                               mesh=None, donate=False)
    rp = jax.tree.map(jnp.asarray, init)
    ro = r_init_opt_state(plan.opt_cfg, rp)
    r_params, r_losses = [rp], []
    for s in range(spec.steps):
        rp, ro, mt = r_step(rp, ro, r_worker_batches(batches[s], M),
                            jax.random.PRNGKey(s))
        r_params.append(rp)
        r_losses.append(float(mt["loss"]))

    nb = [{k: torch.tensor(np.asarray(v)) for k, v in b.items()}
          for b in batches]
    tplan = tresolve(TSpec.from_json(spec.to_json()), device="cpu")
    tplan.batch_fn = lambda s: nb[s]
    params = lm_params_from_numpy(init)
    got = SyncPS().run(tplan, init_state=(
        params, init_opt_state(tplan.opt_cfg, params)))
    assert "eval" not in got.history[0]
    np.testing.assert_allclose([r["loss"] for r in got.history], r_losses,
                               rtol=1e-5)
    if attack == "omniscient":
        np.testing.assert_allclose(
            _flat(lm_params_to_numpy(got.params)), _flat(r_params[-1]),
            rtol=0, atol=1e-4)

    gaps = []
    aggregate = trobust.aggregate_matrix

    def recording(u, *args, **kw):
        out = aggregate(u, *args, **kw)
        # the attack wrote into u: it is the matrix the rule reduced
        center = trmean_ref(u, 1)
        dist = torch.sort((u - center).abs(), dim=0).values
        gaps.append((dist[M - 1] - dist[M - 2]).numpy())
        return out

    monkeypatch.setattr(trobust, "aggregate_matrix", recording)
    t_step = t_make_train_step(tplan.model, robust_cfg=tplan.robust_cfg,
                               opt_cfg=tplan.opt_cfg, num_workers=M)
    for s in range(spec.steps):
        p = lm_params_from_numpy(jax.tree.map(np.asarray, r_params[s]))
        p, _, _ = t_step(p, init_opt_state(tplan.opt_cfg, p),
                         make_worker_batches(nb[s], M), torch.Generator())
        off = np.abs(_flat(lm_params_to_numpy(p))
                     - _flat(r_params[s + 1])) > 1e-4
        assert (gaps[-1][off] < TIE_GAP).all(), (s, off.sum())


@pytest.mark.parametrize("name", ["gemma2-2b-reduced",
                                  "deepseek-v2-lite-16b-reduced"])
def test_remat_modes_give_equal_losses_and_grads(name):
    cfg = t_arch(name)
    params = t_build(cfg).init(torch.Generator().manual_seed(0))
    batch = _worker_batch(cfg.vocab_size)
    out = {r: _port_grads(t_build(cfg, remat=r), params, batch)
           for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        torch.testing.assert_close(out[r], out["none"], rtol=0, atol=0)


def test_remat_under_grad_alone_and_with_worker_params():
    """remat outside the sync step's vmap: streaming takes grad alone,
    async_ps vmaps over per-worker parameter copies."""
    cfg = t_arch("deepseek-v2-lite-16b-reduced")
    params = t_build(cfg).init(torch.Generator().manual_seed(1))
    batch = {k: torch.tensor(v[0]) for k, v in
             _worker_batch(cfg.vocab_size).items()}
    want = torch.func.grad(t_build(cfg).loss)(params, batch)
    for r in ("full", "dots"):
        got = torch.func.grad(t_build(cfg, remat=r).loss)(params, batch)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    wp = tree_util.map(lambda x: torch.stack([x, 1.01 * x]), params)
    wb = {k: torch.stack([v, v.flip(0)]) for k, v in batch.items()}
    want = torch.func.vmap(torch.func.grad(t_build(cfg).loss))(wp, wb)
    got = torch.func.vmap(torch.func.grad(
        t_build(cfg, remat="dots").loss))(wp, wb)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_remat_mode_is_checked():
    cfg = t_arch("gemma2-2b-reduced")
    model = t_build(cfg, remat="some")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat"):
        model.loss(params, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                            "labels": torch.zeros((1, 4), dtype=torch.long)})


def _lm_spec(**overrides):
    base = dict(
        model=rexp.ModelSpec(kind="arch", arch="gemma2-2b-reduced",
                             remat="full"),
        data=rexp.DataSpec(kind="tokens", seq_len=8, batch_per_worker=2),
        robust=RobustConfig(rule="phocas", b=1),
        attack=AttackConfig(name="signflip", num_byzantine=1),
        num_workers=M, steps=2, log_every=1)
    base.update(overrides)
    return TSpec.from_json(rexp.ScenarioSpec(**base).to_json())


def _finite_rows(res, key="loss"):
    vals = [r[key] for r in res.history if key in r]
    assert vals and all(np.isfinite(vals)), res.history
    return vals


def test_async_ps_trains_an_arch_model():
    res = trun(_lm_spec(topology="async_ps"), device="cpu")
    assert len(res.history) == 2
    assert all("loss" not in r and "eval" not in r for r in res.history)
    assert all(torch.isfinite(x).all() for x in tree_util.leaves(res.params))


def test_streaming_equals_the_batch_rule_on_an_arch_model():
    _finite_rows(trun(_lm_spec(topology="streaming"), device="cpu"))
    got = trun(_lm_spec(topology="streaming", steps=1), device="cpu")
    want = trun(_lm_spec(steps=1), device="cpu")
    np.testing.assert_allclose(_finite_rows(got), _finite_rows(want),
                               rtol=1e-5)
    for g, w in zip(tree_util.leaves(got.params),
                    tree_util.leaves(want.params)):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5)


def test_faults_and_compression_train_an_arch_model():
    from repro.compress.spec import CompressionSpec
    from repro.faults.spec import FaultSpec
    crash = (FaultSpec(kind="crash", workers=(3,), step=1),)
    for topo in ("sync_ps", "async_ps", "streaming"):
        res = trun(_lm_spec(topology=topo, faults=crash), device="cpu")
        assert res.history[-1]["present"] == M - 1
        if topo != "async_ps":
            _finite_rows(res)
    res = trun(_lm_spec(compression=CompressionSpec(codec="int8")),
               device="cpu")
    _finite_rows(res)


def test_resume_continues_an_arch_run_bit_for_bit(tmp_path):
    ck = str(tmp_path / "ck")
    spec = dataclasses.replace(_lm_spec(), steps=4, checkpoint_path=ck,
                               checkpoint_every=2)
    full = trun(spec, device="cpu")
    resumed = trun(spec, device="cpu", resume=ck)
    for a, b in zip(tree_util.leaves(full.params),
                    tree_util.leaves(resumed.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_worker_batches_are_checked_on_their_first_leaf():
    from repro_torch.core.robust import RobustConfig as TRobust
    from repro_torch.optim.optimizers import OptConfig
    cfg = t_arch("gemma2-2b-reduced")
    model = t_build(cfg)
    step = t_make_train_step(model, robust_cfg=TRobust(rule="mean", b=0),
                             opt_cfg=OptConfig(), num_workers=M)
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_worker_batches(TokenStream(
        vocab_size=cfg.vocab_size, seq_len=4, global_batch=2 * (M + 1)
    ).batch(0), M + 1)
    with pytest.raises(ValueError, match="worker groups"):
        step(params, init_opt_state(OptConfig(), params), batch,
             torch.Generator())


def test_attention_under_vmap_grad_never_reaches_flash(monkeypatch):
    """On a CUDA tensor the flash kernel takes only serving's prefill calls
    (``flash=True``); training takes ``_attend``.  Pretend CUDA and make
    the flash entry point raise: a training step must not reach it, and a
    prefill call must."""
    import repro_torch.kernels.ops as ops

    def boom(*a, **k):
        raise AssertionError("flash kernel reached")

    monkeypatch.setattr(ops, "flash_attention", boom)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    cfg = t_arch("gemma2-2b-reduced")
    for remat in ("none", "full", "dots"):
        model = t_build(cfg, remat=remat)
        params = model.init(torch.Generator().manual_seed(0))
        batch = {k: torch.tensor(v)
                 for k, v in _worker_batch(cfg.vocab_size).items()}
        losses = torch.func.vmap(torch.func.grad_and_value(model.loss),
                                 in_dims=(None, 0))(params, batch)[1]
        assert torch.isfinite(losses).all()
        # a transform without a gradient: K6 cannot read a batched tensor
        torch.func.vmap(lambda b: model.forward(params, b)[0])(batch)
        one = {k: v[0] for k, v in batch.items()}
        torch.func.grad(model.loss)(params, one)
        with torch.enable_grad():
            p = tree_util.map(lambda x: x.requires_grad_(), params)
            model.loss(p, one).backward()
    q = torch.randn(1, 8, 4, 64)
    C.attention_core(q, q[:, :, :2], q[:, :, :2], torch.arange(8),
                     torch.arange(8))
    with pytest.raises(AssertionError, match="flash kernel reached"):
        C.attention_core(q, q[:, :, :2], q[:, :, :2], torch.arange(8),
                         torch.arange(8), flash=True)
    cache = model.init_cache(1, 8, "cpu")
    with pytest.raises(AssertionError, match="flash kernel reached"):
        model.decode_step(params, cache, batch["tokens"][0, :1, :8], 0)


def test_training_attention_equals_attend_on_cpu():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 8, 4, 16), generator=gen)
    k = torch.randn((2, 8, 2, 16), generator=gen)
    v = torch.randn((2, 8, 2, 16), generator=gen)
    pos = torch.arange(8)

    def f(q):
        return C.attention_core(q, k, v, pos, pos, window=4, cap=50.0)

    def g(q):
        return C._attend(q, k, v, pos, pos, causal=True, window=4, cap=50.0,
                         scale=16 ** -0.5)

    torch.testing.assert_close(f(q), g(q), rtol=0, atol=0)
    torch.testing.assert_close(torch.func.grad(lambda x: f(x).sum())(q),
                               torch.func.grad(lambda x: g(x).sum())(q),
                               rtol=0, atol=0)


def test_flatten_stacked_equals_concatenation_bit_for_bit():
    gen = torch.Generator().manual_seed(0)
    tree = {"b": torch.randn((3, 4, 5), generator=gen).bfloat16(),
            "a": {"w": torch.randn((3, 7), generator=gen)},
            "c": torch.randn((3, 2, 3), generator=gen).half()[:, :, :2]}
    leaves = tree_util.leaves(tree)
    want = torch.cat([x.reshape(3, -1).float() for x in leaves], dim=1)
    got = flatten_stacked(tree)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["gaussian", "omniscient", "signflip",
                                  "zero", "innerprod", "bitplane_flip",
                                  "scale_inflate", "slowburn", "bitflip",
                                  "gambler"])
def test_attacks_write_in_place_only_when_asked(name):
    """The engine hands its (m, D) matrix to the attack, which then writes
    into it: the same values as the copying call, and no second matrix."""
    from repro_torch.core.attacks import (AttackConfig as TAttack,
                                          make_attack, writing_in_place)
    attack = make_attack(TAttack(name=name, num_byzantine=2,
                                 bitflip_dims=30))
    u = torch.randn((8, 60), generator=torch.Generator().manual_seed(0))
    kept = u.clone()
    want = attack(torch.Generator().manual_seed(1), u, 3)
    torch.testing.assert_close(u, kept, rtol=0, atol=0)    # untouched
    with writing_in_place():
        got = attack(torch.Generator().manual_seed(1), u, 3)
    assert got.data_ptr() == u.data_ptr()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_bf16_conversion_keeps_the_router_in_f32():
    name = "deepseek-v2-lite-16b-reduced"
    rc = dataclasses.replace(r_arch(name), param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    rp = jax.eval_shape(r_build(rc).init, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(
        jax.tree.map(lambda x: np.zeros(x.shape, np.float32), rp),
        dtype=torch.bfloat16)
    ffn = tp["stack"]["blocks"]["l0"]["ffn"]
    assert ffn["router"]["w"].dtype == torch.float32
    assert ffn["moe_wi"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.bfloat16
    ref = jax.tree_util.tree_leaves_with_path(rp)
    for (path, r), t in zip(ref, tree_util.leaves(tp)):
        assert (r.dtype == jnp.float32) == (t.dtype == torch.float32), path
    # the port's own init agrees
    tc = dataclasses.replace(t_arch(name), param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    own = t_build(tc).init(torch.Generator().manual_seed(0))
    assert all(a.dtype == b.dtype for a, b in
               zip(tree_util.leaves(own), tree_util.leaves(tp)))
