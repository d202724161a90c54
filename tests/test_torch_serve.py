"""The port's serving path (``repro_torch.serve``, the ``serve`` topology and
``launch/serve.py``) against the reference on the CPU.

Parameters, including the corrupted replica's, are exported from the
reference as numpy and loaded with ``lm_params_from_numpy``, so both engines
decode the same model.  Greedy tokens must be equal; the robust decoder's
reputation within atol 1e-6 and its ``active`` mask exactly, step by step.
``run_experiment`` draws its own weights from the seed (``jax.random`` and
``torch.Generator`` differ), so a scenario run is compared by outcome:
completed requests, tokens, engine steps and ejected replicas.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import (BlockAllocator, OutOfBlocks, PagedKVCache,
                               Request, RobustDecoder, Scheduler, ServeEngine,
                               batched_prefill_supported, generate,
                               generate_stepwise, make_replicas)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-8b-reduced"


@pytest.fixture(scope="module")
def models():
    from repro.configs import get_arch
    from repro.models import build_model
    from repro.serve import corrupt_replica
    rm = build_model(get_arch(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    bad = corrupt_replica((rp, rp), 1, jax.random.PRNGKey(3))[1]
    tm = t_build(t_arch(ARCH))
    as_torch = lambda p: lm_params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, p))
    return rm, rp, bad, tm, as_torch(rp), as_torch(bad)


def _prompts(n, lens, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (lens[i % len(lens)],)).tolist()
            for i in range(n)]


# ---------------------------------------------------------------------------
# Host side: block allocator, paged-cache lifecycle, scheduler
# ---------------------------------------------------------------------------

def _allocator_case(case):
    if case == "block_zero_reserved":
        alloc = BlockAllocator(8)
        got = alloc.alloc(alloc.free_blocks)
        assert 0 not in got and sorted(got) == list(range(1, 8))
    elif case == "out_of_blocks":
        alloc = BlockAllocator(4)
        alloc.alloc(3)
        with pytest.raises(OutOfBlocks):
            alloc.alloc(1)
    elif case == "free_rejects_reserved_and_double_free":
        alloc = BlockAllocator(8)
        blocks = alloc.alloc(2)
        alloc.free(blocks)
        with pytest.raises(ValueError):
            alloc.free([blocks[0]])
        with pytest.raises(ValueError):
            alloc.free([0])
    elif case == "free_returns_capacity":
        alloc = BlockAllocator(8)
        blocks = alloc.alloc(7)
        assert alloc.free_blocks == 0
        alloc.free(blocks)
        assert alloc.free_blocks == 7
    elif case == "needs_two_blocks":
        with pytest.raises(ValueError):
            BlockAllocator(1)


@pytest.mark.parametrize("case", [
    "block_zero_reserved", "out_of_blocks",
    "free_rejects_reserved_and_double_free", "free_returns_capacity",
    "needs_two_blocks"])
def test_block_allocator(case):
    _allocator_case(case)


def test_default_block_size_is_the_references():
    from repro.serve.cache import DEFAULT_BLOCK_TOKENS
    from repro_torch.serve.cache import BLOCK_TOKENS
    assert BLOCK_TOKENS == DEFAULT_BLOCK_TOKENS


@pytest.mark.parametrize("case", ["ensure_release_roundtrip",
                                  "admission_gate", "beyond_table_capacity"])
def test_paged_cache_lifecycle(models, case):
    tm = models[3]
    if case == "ensure_release_roundtrip":
        cache = PagedKVCache(tm, max_slots=2, max_seq_len=32,
                             block_tokens=4)
        total = cache.allocator.free_blocks
        cache.ensure(0, 10)
        assert len(cache.owned_blocks(0)) == 3
        assert (cache.tables[0, :3] > 0).all()
        assert cache.tables[0, 3:].sum() == 0
        cache.ensure(0, 12)
        assert len(cache.owned_blocks(0)) == 3
        cache.ensure(0, 13)
        assert len(cache.owned_blocks(0)) == 4
        cache.release(0)
        assert cache.owned_blocks(0) == [] and cache.tables[0].sum() == 0
        assert cache.allocator.free_blocks == total
        pool = cache.pool["blocks"]["l0"]["mixer"]["k"]
        assert pool.shape == (2, cache.num_blocks, 4, 2, 64)
    elif case == "admission_gate":
        cache = PagedKVCache(tm, max_slots=2, max_seq_len=32,
                             block_tokens=4, num_blocks=5)
        assert cache.can_cover(16) and not cache.can_cover(17)
        cache.ensure(0, 16)
        assert not cache.can_cover(1)
        with pytest.raises(OutOfBlocks):
            cache.ensure(1, 4)
    else:
        cache = PagedKVCache(tm, max_slots=1, max_seq_len=16,
                             block_tokens=4)
        with pytest.raises(OutOfBlocks):
            cache.ensure(0, 17)


def _scheduler_case(case):
    if case == "join_retire_slot_reuse":
        reserved, released = [], []
        sched = Scheduler(max_slots=2, can_cover=lambda t: t <= 8,
                          reserve=lambda s, t: reserved.append((s, t)),
                          release=lambda s: released.append(s),
                          clock=lambda: 0.0)
        a = sched.submit([1, 2], max_new_tokens=2)
        b = sched.submit([3], max_new_tokens=3)
        big = sched.submit([1] * 7, max_new_tokens=9)
        assert sched.admit() == [a, b]
        assert reserved == [(0, 4), (1, 4)]
        sched.mark_decoding(a, 7)
        sched.append_token(a, 8)
        assert a.finished and sched.retire_finished() == [a]
        assert released == [0]
        assert sched.admit() == []
        assert sched.queued == 1 and big.state == "queued"
        assert sched.slot_of(0) is None
        c = sched.submit([5], max_new_tokens=1)
        assert sched.admit() == [] and c.state == "queued"
    elif case == "request_positions":
        r = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4)
        r.generated.append(9)
        assert r.decode_pos == 3
        r.generated.append(9)
        assert r.decode_pos == 4 and r.total_budget == 7
    elif case == "cancel_and_deadlines":
        now = [0.0]
        released = []
        sched = Scheduler(max_slots=1, can_cover=lambda t: True,
                          reserve=lambda s, t: None,
                          release=released.append, clock=lambda: now[0])
        a = sched.submit([1], 4, deadline_s=1.0)
        b = sched.submit([2], 4, deadline_s=5.0)
        assert sched.admit() == [a]
        now[0] = 2.0
        assert sched.expire_deadlines() == [a]
        assert a.state == "cancelled" and released == [0]
        assert sched.cancel(b) and b.state == "cancelled"
        assert not sched.cancel(b) and not sched.busy


@pytest.mark.parametrize("case", ["join_retire_slot_reuse",
                                  "request_positions",
                                  "cancel_and_deadlines"])
def test_scheduler(case):
    _scheduler_case(case)


# ---------------------------------------------------------------------------
# Engines against the reference
# ---------------------------------------------------------------------------

def test_generate_matches_reference_and_stepwise(models):
    from repro.serve import generate as r_generate
    rm, rp, _, tm, tp, _ = models
    prompts = np.random.default_rng(1).integers(0, 512, (3, 5))
    assert batched_prefill_supported(tm.cfg, 5)
    new = generate(tm, tp, torch.tensor(prompts), 6)
    old = generate_stepwise(tm, tp, torch.tensor(prompts), 6)
    ref = r_generate(rm, rp, jnp.asarray(prompts, jnp.int32), 6)
    np.testing.assert_array_equal(new.numpy(), old.numpy())
    np.testing.assert_array_equal(new.numpy(), np.asarray(ref))


def test_windowed_arch_uses_the_stepwise_fallback():
    cfg = t_arch("gemma3-27b-reduced")
    assert not batched_prefill_supported(cfg, prompt_len=10**9)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 4),
                            generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(
        generate(model, params, prompts, 4).numpy(),
        generate_stepwise(model, params, prompts, 4).numpy())
    with pytest.raises(NotImplementedError):
        ServeEngine(model, params, max_slots=2, max_seq_len=16)


def test_engine_continuous_batching_matches_reference(models):
    """Requests joining and retiring mid-loop: each request's tokens equal
    the reference engine's and the port's dense generate."""
    from repro.serve import ServeEngine as RServe
    rm, rp, _, tm, tp, _ = models
    prompts = _prompts(5, lens=(5, 3, 7))
    news = [6, 4, 5, 6, 3]
    gens = {}
    for tag, engine in (("ref", RServe(rm, rp, max_slots=3, max_seq_len=32,
                                       block_tokens=4)),
                        ("port", ServeEngine(tm, tp, max_slots=3,
                                             max_seq_len=32,
                                             block_tokens=4))):
        reqs = [engine.submit(p, n) for p, n in zip(prompts[:3], news[:3])]
        engine.step()
        engine.step()
        reqs += [engine.submit(p, n) for p, n in zip(prompts[3:], news[3:])]
        assert len(engine.run()) == 5
        assert (engine.cache.allocator.free_blocks
                == engine.cache.num_blocks - 1)
        gens[tag] = [r.generated for r in reqs]
    assert gens["port"] == gens["ref"]
    for p, n, g in zip(prompts, news, gens["port"]):
        dense = generate(tm, tp, torch.tensor([p]), n)[0, len(p):]
        assert g == dense.tolist()


def test_robust_decode_matches_reference_step_by_step(models, tmp_path):
    """k=3, one replica corrupted with the reference's garbage parameters:
    phocas tokens equal the clean ones, reputation and active equal the
    reference's at every decode step, and only the corrupted replica ends
    ejected.  Plain mean diverges and never ejects."""
    from repro.defense.telemetry import TelemetryWriter as RWriter
    from repro.serve import RobustDecoder as RDecoder
    from repro.serve import ServeEngine as RServe
    from repro_torch.defense.telemetry import TelemetryWriter, read_jsonl
    rm, rp, rbad, tm, tp, tbad = models
    prompt = _prompts(1, lens=(4,))[0]
    clean = generate(tm, tp, torch.tensor([prompt]), 20)[0, 4:].tolist()
    paths = {t: str(tmp_path / f"{t}.jsonl") for t in ("ref", "port")}
    decs = {}
    with RWriter(paths["ref"]) as tel:
        decs["ref"] = RDecoder(rule="phocas", k=3)
        e = RServe(rm, (rp, rbad, rp), max_slots=1, max_seq_len=32,
                   block_tokens=4, decoder=decs["ref"], telemetry=tel)
        r_req = e.submit(prompt, 20)
        e.run()
    with TelemetryWriter(paths["port"]) as tel:
        decs["port"] = RobustDecoder(rule="phocas", k=3)
        e = ServeEngine(tm, (tp, tbad, tp), max_slots=1, max_seq_len=32,
                        block_tokens=4, decoder=decs["port"], telemetry=tel)
        t_req = e.submit(prompt, 20)
        e.run()
    assert t_req.generated == clean == r_req.generated
    recs = {t: [r for r in read_jsonl(p) if r["kind"] == "robust_decode"]
            for t, p in paths.items()}
    assert len(recs["port"]) == len(recs["ref"]) == 19
    for a, b in zip(recs["port"], recs["ref"]):
        assert a["active"] == b["active"]
        np.testing.assert_allclose(a["reputation"], b["reputation"],
                                   atol=1e-6)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-6)
    assert decs["port"].ejected_replicas() == [1] == \
        decs["ref"].ejected_replicas()

    dec_mean = RobustDecoder(rule="mean", k=3, b=0)
    e = ServeEngine(tm, (tp, tbad, tp), max_slots=1, max_seq_len=32,
                    block_tokens=4, decoder=dec_mean)
    req = e.submit(prompt, 8)
    e.run()
    assert req.generated != clean[:8] and dec_mean.ejected_replicas() == []


def test_replicas_share_tensors_and_corrupt_draws_garbage(models):
    from repro_torch.serve import corrupt_replica
    tp = models[4]
    reps = make_replicas(tp, 3)
    assert all(r is tp for r in reps)
    bad = corrupt_replica(reps, 2, torch.Generator().manual_seed(0))
    assert bad[0] is tp and bad[1] is tp
    w = bad[2]["embed"]["table"]
    assert w.dtype == tp["embed"]["table"].dtype
    assert 15 < w.std().item() < 25
    jit = make_replicas(tp, 2, gen=torch.Generator().manual_seed(0),
                        jitter=0.1)
    assert not torch.equal(jit[0]["embed"]["table"], jit[1]["embed"]["table"])
    with pytest.raises(ValueError, match="Generator"):
        make_replicas(tp, 2, jitter=0.1)


def test_crash_replica_mid_stream_completes_clean(models):
    tm, tp = models[3], models[4]
    prompt = _prompts(1, lens=(4,))[0]
    clean = generate(tm, tp, torch.tensor([prompt]), 8)[0, 4:].tolist()
    dec = RobustDecoder(rule="phocas", k=3, b=1)
    engine = ServeEngine(tm, make_replicas(tp, 3), max_slots=2,
                         max_seq_len=16, block_tokens=4, decoder=dec)
    req = engine.submit(prompt, 8)
    for _ in range(3):
        engine.step()
    engine.crash_replica(2)
    assert (dec.k, dec.b) == (2, 0)
    assert len(engine.params) == 2 and len(engine.pool) == 2
    engine.run()
    assert req.generated == clean
    with pytest.raises(ValueError, match="cannot shrink below k=2"):
        engine.crash_replica(0)
    assert engine.time_decode_step(iters=2) > 0


def test_deadline_and_cancel_release_kv_blocks(models):
    tm, tp = models[3], models[4]
    prompt = _prompts(1, lens=(4,))[0]
    engine = ServeEngine(tm, tp, max_slots=2, max_seq_len=16,
                         block_tokens=4)
    free0 = engine.cache.allocator.free_blocks
    expired = engine.submit(prompt, 8, deadline_s=1e-9)
    live = engine.submit(prompt, 4)
    engine.step()
    assert expired.state == "cancelled"
    engine.step()
    if live.state != "done":
        assert engine.cancel(live)
    assert not engine.cancel(expired)
    while engine.scheduler.busy:
        engine.step()
    assert engine.cache.allocator.free_blocks == free0


def test_engine_validation(models):
    tm, tp = models[3], models[4]
    with pytest.raises(ValueError):
        RobustDecoder(k=1)
    with pytest.raises(ValueError):
        RobustDecoder(k=3, b=2)
    with pytest.raises(ValueError):
        ServeEngine(tm, tp, max_slots=2, max_seq_len=16,
                    decoder=RobustDecoder(k=3))
    engine = ServeEngine(tm, tp, max_slots=1, max_seq_len=8)
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.submit([1] * 6, 3)


def test_replica_telemetry_and_metrics(models, tmp_path):
    from repro_torch.defense.telemetry import read_jsonl
    from repro_torch.obs import ObsConfig, make_recorder
    tm, tp, tbad = models[3], models[4], models[5]
    path = str(tmp_path / "tel.jsonl")
    with make_recorder(path, ObsConfig(enabled=True, trace=True)) as rec:
        engine = ServeEngine(tm, (tbad, tp, tp), max_slots=1, max_seq_len=24,
                             block_tokens=4,
                             decoder=RobustDecoder(rule="phocas", k=3),
                             telemetry=rec)
        engine.submit([1, 2, 3], 20)
        engine.run()
        assert rec.registry.get("ejections", stream="robust_decode").value \
            == 1
        assert rec.registry.get("span_ms", name="decode", slots=1,
                                k=3).count == 19
    records = read_jsonl(path)
    assert {"robust_decode", "serve", "span", "metric"} <= \
        {r["kind"] for r in records}
    scored = [r for r in records if r["kind"] == "robust_decode"]
    assert scored[-1]["scores"][0] > max(scored[-1]["scores"][1:])
    with pytest.raises(NotImplementedError, match="item 14"):
        make_recorder(None, ObsConfig(metrics_path=str(tmp_path / "m")))


# ---------------------------------------------------------------------------
# The serve topology and the CLI
# ---------------------------------------------------------------------------

def test_serve_scenario_outcomes_match_reference():
    from repro.experiment import ScenarioSpec as RSpec
    from repro.experiment import run_experiment as r_run
    from repro_torch.experiment import ScenarioSpec, run_experiment
    path = os.path.join(REPO, "examples", "scenarios", "serve_gaussian.json")
    ref = r_run(RSpec.load(path)).final_metrics
    res = run_experiment(ScenarioSpec.load(path), device="cpu")
    got = res.final_metrics
    for key in ("completed", "tokens", "engine_steps", "ejected_replicas"):
        assert got[key] == ref[key], key
    assert got["ejected_replicas"] == 1
    assert res.defense_state["active"].tolist() == [1.0, 1.0, 0.0]
    assert sorted(len(r.generated) for r in res.requests) == [8, 8, 8]


@pytest.mark.parametrize("change,err", [
    (dict(model_kind="mlp"), "decodes an arch-zoo model"),
    (dict(arch="gemma2-2b-reduced"), "not paged-serving capable"),
    (dict(b=2), "0 <= robust.b"),
    (dict(attack="signflip"), "cannot be simulated"),
    (dict(byz=2), "tolerates at most"),
])
def test_serve_spec_validation(change, err):
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.experiment import ScenarioSpec, SpecError
    from repro_torch.experiment.spec import DataSpec, ModelSpec
    spec = ScenarioSpec.load(os.path.join(REPO, "examples", "scenarios",
                                          "serve_gaussian.json"))
    if "model_kind" in change:
        spec = dataclasses.replace(spec, model=ModelSpec(),
                                   data=DataSpec())
    if "arch" in change:
        spec = dataclasses.replace(spec, model=dataclasses.replace(
            spec.model, arch=change["arch"]))
    if "b" in change:
        spec = dataclasses.replace(spec, robust=dataclasses.replace(
            spec.robust, b=change["b"]))
    if "attack" in change:
        spec = dataclasses.replace(spec, attack=AttackConfig(
            name=change["attack"], num_byzantine=1))
    if "byz" in change:
        spec = dataclasses.replace(spec, attack=dataclasses.replace(
            spec.attack, num_byzantine=change["byz"]))
    with pytest.raises(SpecError, match=err):
        spec.validate()


def test_serve_cli_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--arch", ARCH])
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(["--arch", ARCH, "--mesh", "2x1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.main(["--arch", ARCH, "--profile-dir", "p", "--device", "cpu"])
    cli.main(["--arch", ARCH, "--engine", "--replicas", "3", "--corrupt",
              "1", "--batch", "2", "--prompt-len", "4", "--new-tokens", "16",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "engine (robust k=3 phocas): 2 requests, 32 tokens" in out
    assert "ejected: [2]" in out
    cli.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "4",
              "--new-tokens", "3", "--device", "cpu"])
    assert "generated (2, 7)" in capsys.readouterr().out
