"""The rest of the LM zoo in the port against the reference, CPU, f32: the
Mamba2 SSM (mamba2-2.7b), the hybrid attention + SSM stack (hymba-1.5b),
the whisper encoder-decoder (whisper-large-v3) and the VLM projector
(internvl2-26b), each at its ``-reduced`` config.

Parameters come from the reference's ``init`` through
``lm_params_from_numpy``; the same numpy tokens, patch and frame embeddings
go to both packages.  The bounds are those of ``test_torch_lm.py`` and
``test_torch_lm_train.py``: logits within atol 1e-4, losses within rtol
1e-5, per-worker gradients within atol 1e-4 + rtol 1e-3, a sync_ps run's
parameters within atol 1e-4 (XLA and PyTorch sum in other orders).  Decode
is held to the reference's decode (1e-4) and to the port's own forward at
the reference's ``test_decode_matches_forward`` bound (atol 2e-3, rtol
1e-3).  The remat modes give bit-equal losses and gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_arch
from repro.models import build_model as r_build
from repro.models import encdec as r_encdec
from repro_torch import tree as tree_util
from repro_torch.configs import get_arch as t_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import encdec as t_encdec
from repro_torch.models.registry import build_model as t_build

ZOO = ("mamba2-2.7b-reduced", "hymba-1.5b-reduced",
       "whisper-large-v3-reduced", "internvl2-26b-reduced")
ATOL = 1e-4
M, B, S = 4, 2, 16


def _batch(cfg, Bsz, Slen, seed=0):
    """Numpy tokens, labels and the stub frontends' embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (Bsz, Slen)),
           "labels": rng.integers(0, cfg.vocab_size, (Bsz, Slen))}
    if cfg.num_patches:          # N(0, 1): GELU's tanh form shows at 1e-4
        out["patch_embeds"] = rng.standard_normal(
            (Bsz, cfg.num_patches, cfg.vit_dim))
    if cfg.is_encdec:
        out["audio_embeds"] = 0.1 * rng.standard_normal(
            (Bsz, cfg.encoder_seq_len, cfg.frontend_dim))
    return {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
            for k, v in out.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def zoo():
    """Per arch: (reference model, reference params, port model, port
    params), the port's a copy of the reference's."""
    out = {}
    for name in ZOO:
        rm, tm = r_build(r_arch(name)), t_build(t_arch(name))
        rp = rm.init(jax.random.PRNGKey(0))
        out[name] = (rm, rp, tm, lm_params_from_numpy(
            jax.tree.map(np.asarray, rp)))
    return out


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def test_bf16_conversion_keeps_the_ssm_leaves_f32():
    """A tree converted to bf16 keeps ``dt_bias``, ``A_log`` and ``D`` in
    f32 with their values, as the reference holds them."""
    cfg = t_arch("hymba-1.5b-reduced")
    tree = lm_params_to_numpy(
        t_build(cfg).init(torch.Generator().manual_seed(0)))
    tp = lm_params_from_numpy(tree, dtype=torch.bfloat16)
    mixer = tp["stack"]["blocks"]["l0"]["mixer_ssm"]
    for k in ("dt_bias", "A_log", "D"):
        assert mixer[k].dtype == torch.float32
        np.testing.assert_array_equal(
            mixer[k].numpy(), tree["stack"]["blocks"]["l0"]["mixer_ssm"][k])
    assert mixer["conv_w"].dtype == torch.bfloat16
    assert tp["stack"]["blocks"]["l0"]["mixer"]["wq"]["w"].dtype \
        == torch.bfloat16


# ---------------------------------------------------------------------------
# Forward, loss, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_forward_and_loss_match_reference(name, zoo):
    rm, rp, tm, tp = zoo[name]
    batch = _batch(rm.cfg, 2, S, seed=1)
    r_logits, r_loss = jax.jit(lambda p, b: (rm.forward(p, b)[0],
                                             rm.loss(p, b)))(rp, _jax(batch))
    t_logits, aux = tm.forward(tp, _torch(batch))
    assert float(aux) == 0.0
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=ATOL)
    t_loss = tm.loss(tp, _torch(batch))
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-5)


def _decode(params, cache, toks, step, wrap=lambda x: x):
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(params, cache, wrap(toks[:, t:t + 1]), t)
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, 1)


@pytest.mark.parametrize("name", ZOO)
def test_decode_matches_reference_and_forward(name, zoo):
    """Token by token through the decode cache: against the reference's
    decode within 1e-4 and against the port's own forward within the
    reference's 2e-3 / 1e-3.  Whisper first fills its cross-attention
    cache with ``prefill_cache``; internvl2's decode embeds tokens only,
    so its forward (whose first positions are patches) is not a
    counterpart."""
    rm, rp, tm, tp = zoo[name]
    cfg = tm.cfg
    batch = _batch(cfg, 2, 12, seed=2)
    toks = batch["tokens"]
    rc, tc = rm.init_cache(2, 12), tm.init_cache(2, 12)
    if cfg.is_encdec:
        rc = r_encdec.prefill_cache(rp, rm.cfg, rc,
                                    jnp.asarray(batch["audio_embeds"]))
        same = t_encdec.prefill_cache(tp, cfg, tc,
                                      torch.tensor(batch["audio_embeds"]))
        assert same is tc
        np.testing.assert_allclose(tc["cross"]["k"].numpy(),
                                   np.asarray(rc["cross"]["k"]), atol=ATOL)
    r_step = jax.jit(rm.decode_step)
    want = _decode(rp, rc, toks,
                   lambda p, c, t, i: r_step(p, c, t, jnp.int32(i)),
                   jnp.asarray)
    got = _decode(tp, tc, toks, tm.decode_step, torch.tensor)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if not cfg.num_patches:
        full, _ = tm.forward(tp, _torch(batch))
        np.testing.assert_allclose(got, full.numpy(), atol=2e-3, rtol=1e-3)


def test_hybrid_ring_buffer_wraparound():
    """hymba with window 4 (as ``tests/test_models.py``'s ring test): 12
    decode steps wrap the attention ring twice beside the SSM state, and
    match the port's forward and the reference's."""
    rcfg = dataclasses.replace(r_arch("hymba-1.5b-reduced"),
                               window_pattern=(4,))
    tcfg = dataclasses.replace(t_arch("hymba-1.5b-reduced"),
                               window_pattern=(4,))
    rm, tm = r_build(rcfg), t_build(tcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, rp))
    batch = _batch(tcfg, 2, 12, seed=3)
    full, _ = tm.forward(tp, _torch(batch))
    r_full, _ = jax.jit(rm.forward)(rp, _jax(batch))
    np.testing.assert_allclose(full.numpy(), np.asarray(r_full), atol=ATOL)
    got = _decode(tp, tm.init_cache(2, 12), batch["tokens"], tm.decode_step,
                  torch.tensor)
    assert tm.init_cache(2, 12)["blocks"]["l0"]["mixer"]["k"].shape[2] == 4
    np.testing.assert_allclose(got, full.numpy(), atol=2e-3, rtol=1e-3)


def test_vlm_patch_positions_masked_in_loss(zoo):
    """Labels at patch positions do not move the loss (as the reference's
    test); the patch projections replace the first positions; with every
    position a patch the loss is 0, as the reference's."""
    rm, rp, tm, tp = zoo["internvl2-26b-reduced"]
    P = tm.cfg.num_patches
    b1 = _torch(_batch(tm.cfg, 2, S, seed=4))
    b2 = dict(b1, labels=b1["labels"].clone())
    b2["labels"][:, :P] = 0
    torch.testing.assert_close(tm.loss(tp, b1), tm.loss(tp, b2), rtol=1e-6,
                               atol=0)
    b3 = dict(b1, tokens=b1["tokens"].clone())
    b3["tokens"][:, :P] = 7
    torch.testing.assert_close(tm.forward(tp, b1)[0], tm.forward(tp, b3)[0],
                               rtol=0, atol=0)
    short = {k: v[:, :P] if k in ("tokens", "labels") else v
             for k, v in b1.items()}
    assert float(tm.loss(tp, short)) == 0.0
    assert float(jax.jit(rm.loss)(rp, {k: jnp.asarray(v.numpy())
                                       for k, v in short.items()})) == 0.0


# ---------------------------------------------------------------------------
# Training: per-worker gradients, sync_ps, remat
# ---------------------------------------------------------------------------

def _worker_batch(cfg, seed=0):
    flat = _batch(cfg, M * B, S, seed=seed)
    return {k: v.reshape(M, B, *v.shape[1:]) for k, v in flat.items()}


@pytest.mark.parametrize("name", ZOO)
def test_per_worker_losses_and_grads_match_reference(name, zoo):
    """m = 4 workers' losses and gradients (the train step's vmap of
    ``grad_and_value``), as ``test_smoke_one_train_step`` takes them."""
    rm, rp, tm, tp = zoo[name]
    batch = _worker_batch(tm.cfg, seed=5)
    r_loss, r_grads = jax.jit(jax.vmap(jax.value_and_grad(rm.loss),
                                       in_axes=(None, 0)))(rp, _jax(batch))
    t_grads, t_loss = torch.func.vmap(torch.func.grad_and_value(tm.loss),
                                      in_dims=(None, 0))(tp, _torch(batch))
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(r_loss),
                               rtol=1e-5, atol=1e-5)
    got = tree_util.leaves(lm_params_to_numpy(t_grads))
    want = jax.tree.leaves(r_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-3)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


# steps of the sync_ps run held to the reference: 3 (a trajectory) on
# mamba2 and whisper, one robust step on the other two
SYNC_STEPS = {"mamba2-2.7b-reduced": 3, "whisper-large-v3-reduced": 3,
              "hymba-1.5b-reduced": 1, "internvl2-26b-reduced": 1}


@pytest.mark.parametrize("name", ZOO)
def test_sync_ps_steps_match_reference(name, zoo):
    """``SyncPS`` through ``plan_from_parts`` with trmean b = 1 at m = 4
    (``test_smoke_one_train_step``'s rule) under signflip q = 1, SGD 0.05,
    on numpy batches (the token stream carries no patch or frame
    embeddings): losses within rtol 1e-5, parameters within 1e-4 of the
    reference's train step stepped as often.  Trmean is continuous in its
    inputs, so the two packages' rounding cannot flip a selection."""
    from repro.core.attacks import AttackConfig as RAttack
    from repro.core.robust import RobustConfig as RRobust
    from repro.data.pipeline import make_worker_batches as r_split
    from repro.optim import OptConfig as ROpt
    from repro.optim import init_opt_state as r_init_opt
    from repro.train.step import make_train_step as r_make_step
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.experiment.runner import plan_from_parts
    from repro_torch.experiment.topologies import SyncPS
    from repro_torch.optim import OptConfig
    from repro_torch.optim.optimizers import init_opt_state

    rm, rp0, tm, tp0 = zoo[name]
    steps = SYNC_STEPS[name]
    batches = [_batch(tm.cfg, M * B, S, seed=10 + s) for s in range(steps)]
    r_step = r_make_step(
        rm, robust_cfg=RRobust(rule="trmean", b=1, q=1,
                               attack=RAttack(name="signflip",
                                              num_byzantine=1)),
        opt_cfg=ROpt(name="sgd", lr=0.05), num_workers=M, mesh=None,
        donate=False)
    rp, ro = rp0, r_init_opt(ROpt(name="sgd", lr=0.05), rp0)
    r_losses = []
    for s in range(steps):
        rp, ro, mt = r_step(rp, ro, r_split(_jax(batches[s]), M),
                            jax.random.PRNGKey(s))
        r_losses.append(float(mt["loss"]))

    params = tree_util.map(torch.clone, tp0)
    plan = plan_from_parts(
        model=tm, batch_fn=lambda s: _torch(batches[s]),
        robust_cfg=RobustConfig(rule="trmean", b=1, q=1,
                                attack=AttackConfig(name="signflip",
                                                    num_byzantine=1)),
        opt_cfg=OptConfig(name="sgd", lr=0.05), num_workers=M, steps=steps,
        record_every=1, device="cpu")
    res = SyncPS().run(plan, init_state=(
        params, init_opt_state(plan.opt_cfg, params)))
    np.testing.assert_allclose([r["loss"] for r in res.history], r_losses,
                               rtol=1e-5)
    np.testing.assert_allclose(_flat(lm_params_to_numpy(res.params)),
                               _flat(rp), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ZOO)
def test_remat_modes_give_equal_losses_and_grads(name, zoo):
    """"none", "full" and "dots" bit for bit (enc-dec: "dots" is "full",
    as the reference's plain ``jax.checkpoint`` of each layer)."""
    cfg = zoo[name][2].cfg
    params = zoo[name][3]
    batch = _torch(_worker_batch(cfg, seed=6))
    out = {r: torch.func.vmap(
        torch.func.grad_and_value(t_build(cfg, remat=r).loss),
        in_dims=(None, 0))(params, batch) for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        torch.testing.assert_close(out[r], out["none"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat"):
        t_build(cfg, remat="some").loss(params, {k: v[0] for k, v in
                                                 batch.items()})


# ---------------------------------------------------------------------------
# The dense serving tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_generate_matches_stepwise_and_reference(name, zoo):
    """``generate`` (stepwise for the recurrent and enc-dec caches, one
    batched prefill for internvl2) equals ``generate_stepwise`` and the
    reference's ``generate``."""
    from repro.serve import generate as r_generate
    from repro_torch.serve import generate, generate_stepwise
    rm, rp, tm, tp = zoo[name]
    prompts = _batch(tm.cfg, 3, 5, seed=7)["tokens"]
    got = generate(tm, tp, torch.tensor(prompts), 4)
    torch.testing.assert_close(
        got, generate_stepwise(tm, tp, torch.tensor(prompts), 4),
        rtol=0, atol=0)
    want = r_generate(rm, rp, jnp.asarray(prompts), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_prefill_reaches_flash_on_cuda_tensors(zoo, monkeypatch):
    """On a CUDA tensor, ``generate``'s batched prefill (from position 0,
    into a cache longer than the prompt) sends each layer's attention to
    the flash-attention kernel once with Sq == T == the prompt's length, as
    phase 9 of ``chip_smoke.py`` counts on internvl2.  CUDA is pretended
    and the kernel answered by its plain version; the tokens equal the
    stepwise oracle's."""
    import repro_torch.kernels.ops as ops
    from repro_torch.kernels.flashattn.ref import flash_attention_ref
    from repro_torch.serve import generate, generate_stepwise
    calls = []

    def record(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return flash_attention_ref(q, k, v, **kw)

    rm, rp, tm, tp = zoo["internvl2-26b-reduced"]
    prompts = torch.tensor(_batch(tm.cfg, 3, 5, seed=8)["tokens"])
    with monkeypatch.context() as mp:
        mp.setattr(ops, "flash_attention", record)
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        got = generate(tm, tp, prompts, 4)
    assert calls == [(5, 5)] * tm.cfg.num_layers
    torch.testing.assert_close(
        got, generate_stepwise(tm, tp, prompts, 4), rtol=0, atol=0)


def test_serve_cli_decodes_an_ssm_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-2.7b-reduced", "--batch", "2",
                "--prompt-len", "3", "--new-tokens", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 5)" in out


# ---------------------------------------------------------------------------
# A reference-side fact the port reproduces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["whisper-large-v3-reduced",
                                  "internvl2-26b-reduced"])
def test_run_experiment_has_no_frontend_embeddings(name):
    """``run_experiment`` trains an arch on the token stream, which carries
    no ``audio_embeds`` or ``patch_embeds``: both packages raise KeyError
    on the first step."""
    from repro import experiment as rexp
    from repro.core.attacks import AttackConfig as RAttack
    from repro.core.robust import RobustConfig as RRobust
    from repro_torch.experiment import ScenarioSpec, run_experiment
    spec = rexp.ScenarioSpec(
        name="frontend", model=rexp.ModelSpec(kind="arch", arch=name),
        data=rexp.DataSpec(kind="tokens", seq_len=S, batch_per_worker=B),
        robust=RRobust(rule="trmean", b=1, q=1),
        attack=RAttack(name="none", num_byzantine=0),
        num_workers=M, steps=1, log_every=1)
    key = "audio_embeds" if "whisper" in name else "patch_embeds"
    with pytest.raises(KeyError, match=key):
        rexp.run_experiment(spec)
    with pytest.raises(KeyError, match=key):
        run_experiment(ScenarioSpec.from_json(spec.to_json()), device="cpu")
