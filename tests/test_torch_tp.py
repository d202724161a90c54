"""Serving and training on a (data, model) mesh with tensor-parallel compute,
in the port against the reference, on one gloo world of 4 CPU ranks.

One module-scoped spawn of a (2, 2) mesh (``torch_tp_ranks.py``) runs
every case; the serve CLI's own spawn of a "2x1" mesh follows it.  Every
model starts from the port's init (seed 0), converted for the reference.
Serving: ``generate`` and ``generate_stepwise`` on granite-8b-reduced
(B = 4, the batch sharded over the data axis, and B = 3, replicated over
it), gemma2-2b-reduced (windows, softcaps, the tied table), a made-up
3-head x 8 config whose ``wq`` the model axis splits mid-head,
deepseek-v2-lite-reduced (MLA and the MoE, whose data-shard grouping
takes the grouped branch in the prefill and the ungrouped one in decode),
and the SSM, hybrid, enc-dec and VLM families (mamba2-2.7b-, hymba-1.5b-,
whisper-large-v3- and internvl2-26b-reduced; whisper at the serve CLI's
``--batch 2 --prompt-len 4 --new-tokens 2`` on the prompts the CLI draws,
its cache cut on its own batch dim over the data axis, and once more
against the audio's cross-attention K/V).  Tokens equal
``repro.serve.generate`` without a mesh (the reference's own claim: a
mesh does not change its tokens), the first two steps' logits within
1e-5; the MoE is held to the reference with its ``data_axis_size``
monkeypatched to 2, the reference's grouped semantics on one device.  The
serve CLI prints the reference's tokens alone, with ``--mesh 2x2`` and
with ``--mesh 2x1``.  Training: 3 ``sync_ps`` steps on gemma2-2b-,
deepseek-v2-lite-, mamba2-2.7b- and hymba-1.5b-reduced on the port's
token batches, against the reference's ``sync_ps`` topology (what
``run_experiment`` runs) from the same params on the same batches and the
port's single-process run, at ``test_torch_train.py``'s tolerances, and
with ``SEQ_SHARD`` (the sequence-sharded residual stream) against the run
without it.  One batch's loss and gradient of whisper and internvl2 (with
their frontend embeddings, which ``run_experiment`` does not give them)
and of a mamba2 with a tail layer (whose per-head leaves ``tree_pspecs``
leaves whole) against ``jax.value_and_grad`` of the reference's loss.
Every rank holds only its ``tree_pspecs`` blocks of params and optimizer
state, and its cache blocks, counted in bytes.  Without a world, the
port's ``moe_block`` under a pure data-2 mesh description equals the
monkeypatched reference's in both branches.

The same world then makes a (1, 4) mesh, whose 4 model ranks split the
q heads but not the K/V heads of granite-8b-reduced (4/2: each rank its
q head and the K/V head its group reads) nor the q heads of a 6/2
gemma2-2b-reduced (padded to 8, 2 a rank, the last rank none): one
batch's loss and gradient (remat full) and the serving step's logits
equal the single process's, and each rank attends over its head block
alone.  And it runs the FSDP streaming step (``train/streaming.py``'s
mesh form) on a (4, 1) mesh (m = 4 workers, b = 1, each worker's 4 rows
one a rank) and a (2, 2) one (m = 2, b = 0, tensor-parallel compute on
the gathered blocks), the MLP and gemma2-2b-reduced, step for step
against the port's one-process streaming step under the deterministic
attacks (``test_torch_streaming.py``'s tolerances) and by bands under
gaussian; every rank holds a quarter of gemma2's params, momentum and
bottom statistic; and the ``streaming`` topology with a (4, 1) mesh on
its plan equals the reference's ``run_experiment`` from the same params
on the same batches.

Last, the world makes a (2, 2) and a (4, 1) mesh whose axes take the NCCL
collective forms (one call a collective, a real reduce-scatter; gloo takes
those calls on CPU tensors): all_gathers and all_to_alls equal the gloo
forms' bit for bit, ``reduce_scatter_to_model`` equals the all_reduce and
cut within rtol 1e-6 in f32 and one ulp in bf16, and gemma2-2b-reduced's
``SEQ_SHARD`` run and the MLP's FSDP streaming step equal the gloo forms'
(losses rtol 1e-5, params rtol 1e-5, atol 1e-7) and the reference at the
tolerances above.
"""
import concurrent.futures
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as r_moe
import repro.serve.engine as r_engine
import repro.models.encdec as r_encdec
from repro import experiment as rexp
from repro.configs import get_arch as r_arch
from repro.core.attacks import AttackConfig
from repro.core.robust import RobustConfig
from repro.experiment.topology import make_topology
from repro.models import build_model as r_build
from repro.optim.optimizers import init_opt_state as r_init_opt_state
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
from torch_tp_ranks import (MESH, NCCL_STREAM, NCCL_TRAIN, stream_single,
                            tp_rank)

# case -> (arch, config changes, batch, prompt tokens, MoE grouping,
#          generated tokens a prompt)
SERVE = {
    "granite B=4": ("granite-8b-reduced", {}, 4, 8, False, 4),
    "granite B=3": ("granite-8b-reduced", {}, 3, 8, False, 4),
    "gemma2": ("gemma2-2b-reduced", {}, 4, 8, False, 4),
    "3 heads x 8": ("granite-8b-reduced",
                    dict(name="granite-3x8-reduced", num_heads=3,
                         num_kv_heads=1, head_dim=8), 2, 8, False, 4),
    "deepseek": ("deepseek-v2-lite-16b-reduced", {}, 2, 8, True, 4),
    "mamba2": ("mamba2-2.7b-reduced", {}, 4, 8, False, 4),
    "hymba": ("hymba-1.5b-reduced", {}, 4, 8, False, 4),
    "whisper": ("whisper-large-v3-reduced", {}, 2, 4, False, 2),
    "internvl2": ("internvl2-26b-reduced", {}, 4, 8, False, 4),
}
TRAIN = ("gemma2-2b-reduced", "deepseek-v2-lite-16b-reduced",
         "mamba2-2.7b-reduced", "hymba-1.5b-reduced")
# the training runs repeated with the sequence-sharded residual stream
SEQ_SHARDED = ("gemma2-2b-reduced", "deepseek-v2-lite-16b-reduced",
               "hymba-1.5b-reduced")
# case -> (arch, config changes): one batch's loss and gradient against
# the reference's; "mamba2 + tail" is a mamba2 with a third layer, whose
# period of 2 leaves a tail layer outside the stacked ``blocks``: its 1-d
# per-head leaves are whole.
GRAD = {"whisper": ("whisper-large-v3-reduced", {}),
        "internvl2": ("internvl2-26b-reduced", {}),
        "mamba2 + tail": ("mamba2-2.7b-reduced",
                          dict(num_layers=3, window_pattern=(None, None)))}
GRAD_TOKENS = 16            # a batch's sequence length (internvl2: 8
                            # patches, 8 tokens)
# The serve CLI's whisper run: the "whisper" serving case's arch, batch,
# prompt and new tokens, whose prompts are the ones the CLI draws.
CLI = ["--arch", "whisper-large-v3-reduced", "--batch", "2",
       "--prompt-len", "4", "--new-tokens", "2", "--device", "cpu"]
CLI_CASE = "whisper"
DESC = Mesh(("data", "model"), MESH)
# case -> (arch, config changes): attention on a (1, 4) mesh whose model
# axis splits the q heads but not the K/V heads ("kv"), or neither ("pad")
HEADS = {"granite kv": ("granite-8b-reduced", {}),
         "gemma2 6/2 pad": ("gemma2-2b-reduced",
                            dict(num_heads=6, num_kv_heads=2))}
HEADS_MESH = (1, 4)
# case -> (model, rule, attack, (data, model) mesh, steps): the FSDP
# streaming step on the world against the one-process streaming step
# (gemma2's steps kept few: each costs 2m gradients through the world's
# collectives)
STREAM = {
    "mlp trmean signflip": ("mlp", "trmean", "signflip", (4, 1), 2),
    "mlp phocas signflip": ("mlp", "phocas", "signflip", (4, 1), 2),
    "mlp phocas zero": ("mlp", "phocas", "zero", (4, 1), 2),
    "gemma2 trmean signflip": ("gemma2-2b-reduced", "trmean", "signflip",
                               (4, 1), 1),
    # gemma2's phocas one step, whose worker matrix the tie check reads
    # (each step meets a few distance ties among 1.3 M coordinates)
    "gemma2 phocas signflip": ("gemma2-2b-reduced", "phocas", "signflip",
                               (4, 1), 1),
    "gemma2 phocas zero": ("gemma2-2b-reduced", "phocas", "zero", (4, 1), 1),
    "gemma2 mean on 2x2": ("gemma2-2b-reduced", "mean", "none", (2, 2), 1),
    "gemma2 phocas gaussian": ("gemma2-2b-reduced", "phocas", "gaussian",
                               (4, 1), 2),
}
STREAM_BANDED = ("gemma2 phocas gaussian",)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_params(arch, changes, seed=0):
    cfg = dataclasses.replace(t_arch(arch), **changes)
    return lm_params_to_numpy(
        t_build(cfg).init(torch.Generator().manual_seed(seed)))


def _prompts(arch, changes, batch, prompt_len):
    vocab = dataclasses.replace(r_arch(arch), **changes).vocab_size
    return np.random.default_rng(batch).integers(
        0, vocab, (batch, prompt_len)).astype(np.int32)


def _cli_prompts(arch, batch, prompt_len, seed=0):
    """The prompts ``launch.serve`` draws on the CPU at ``--seed``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, t_arch(arch).vocab_size, (batch, prompt_len),
                         generator=gen).numpy().astype(np.int32)


def _audio(cfg, batch):
    return np.random.default_rng(7).standard_normal(
        (batch, cfg.encoder_seq_len, cfg.frontend_dim)).astype(np.float32)


def _grad_batch(cfg):
    """A numpy batch of 2 sequences of GRAD_TOKENS tokens, with the stub
    frontends' embeddings."""
    rng = np.random.default_rng(11)
    shape = (2, GRAD_TOKENS)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, shape).astype(
                 np.int32)}
    if cfg.num_patches:
        batch["patch_embeds"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.vit_dim)).astype(np.float32)
    if cfg.is_encdec:
        batch["audio_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def _reference_grad(arch, changes, params, batch):
    """``jax.value_and_grad`` of the reference model's loss."""
    rm = r_build(dataclasses.replace(r_arch(arch), **changes))
    loss, grads = jax.jit(jax.value_and_grad(rm.loss))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


def _reference_audio(arch, changes, params, prompts, audio, total):
    """The reference's logits of a first decode step against the audio's
    cross-attention K/V (``encdec.prefill_cache``)."""
    cfg = dataclasses.replace(r_arch(arch), **changes)
    p = jax.tree.map(jnp.asarray, params)
    cache = r_encdec.prefill_cache(
        p, cfg, r_encdec.init_cache(cfg, prompts.shape[0], total),
        jnp.asarray(audio))
    logits, _ = r_encdec.decode_step(p, cfg, cache,
                                     jnp.asarray(prompts[:, :1]),
                                     jnp.asarray(0))
    return np.asarray(logits)


def _reference_serving(arch, changes, prompts, grouped, params, new):
    """The reference's tokens from ``generate`` without a mesh, and the
    logits of the first two steps ``generate`` makes (its prefill and its
    first decode step, fed the first generated token; or its first two
    prompt tokens where it steps the prompt)."""
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
                          jnp.asarray(prompts), new)
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


def _port_batches(rspec) -> list:
    """The batches of the spec's token stream in the port, as numpy."""
    plan = tresolve(TSpec.from_json(rspec.to_json()), device="cpu")
    return [{k: v.numpy() for k, v in plan.batch_fn(s).items()}
            for s in range(rspec.steps)]


def _reference_run(rspec, init, batches):
    """The reference's sync_ps run of ``rspec`` (the topology that
    ``run_experiment`` dispatches to) from ``init`` on ``batches``."""
    plan = rexp.resolve(rspec)
    feed = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    plan.batch_fn = lambda s: feed[s]
    params = jax.tree.map(jnp.asarray, init)
    return make_topology(plan.topology).run(plan, init_state=(
        params, r_init_opt_state(plan.opt_cfg, params), None))


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


def _cli_mesh(argv: list, mesh: str) -> str:
    """What ``python -m repro_torch.launch.serve`` prints with ``argv`` and
    ``--mesh``: from a process with no world it spawns its ranks."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--mesh", mesh], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _stream_spec_case():
    """The reference's MLP streaming spec (m = 4, phocas b = 1 under
    signflip, 4 rows a worker), its run from its own params on its own
    batches, and those inputs for the port's run on a (4, 1) mesh."""
    spec = rexp.ScenarioSpec(
        name="stream-mesh", topology="streaming",
        model=rexp.ModelSpec(kind="mlp"),
        data=rexp.DataSpec(dim=16, batch_per_worker=4),
        robust=RobustConfig(rule="phocas", b=1, q=1),
        attack=AttackConfig(name="signflip", num_byzantine=1),
        num_workers=4, steps=3, log_every=1)
    plan = rexp.resolve(spec)
    init = jax.tree.map(np.asarray,
                        plan.model.init(jax.random.PRNGKey(spec.seed)))
    batches = [jax.tree.map(np.asarray, plan.batch_fn(s))
               for s in range(spec.steps)]
    ref = rexp.run_experiment(spec)
    return (dict(spec_json=spec.to_json(), init=init, batches=batches),
            ref)


def _heads_single(arch, changes, params, batch, prompts) -> dict:
    """The single process's loss, gradient and serving logits of a head
    case (what ``torch_tp_ranks._heads`` computes on the mesh)."""
    from repro_torch.serve.engine import make_serve_step
    model = t_build(dataclasses.replace(t_arch(arch), **changes),
                    remat="full")
    p = lm_params_from_numpy(params)
    grads, loss = torch.func.grad_and_value(model.loss)(
        p, {k: torch.tensor(v) for k, v in batch.items()})
    prompts = torch.tensor(prompts).long()
    cache = model.init_cache(prompts.shape[0], prompts.shape[1] + 1)
    step = make_serve_step(model)
    nxt, pre, cache = step(p, cache, prompts, torch.arange(prompts.shape[1]))
    _, dec, _ = step(p, cache, nxt, prompts.shape[1])
    return {"loss": float(loss), "grads": lm_params_to_numpy(grads),
            "prefill": pre.numpy(), "decode": dec.numpy()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's values and the (2, 2) world's, for every case: the
    inputs first (every model's params are the port's init, every
    training run's batches the port's token stream), then the world runs
    in a thread, followed there by the serve CLI on a "2x1" mesh of its
    own, while this process computes the reference's values."""
    serve_cases, train_cases, grad_cases, specs = {}, {}, {}, {}
    for key, (arch, changes, batch, plen, _, new) in SERVE.items():
        prompts = (_cli_prompts(arch, batch, plen) if key == CLI_CASE
                   else _prompts(arch, changes, batch, plen))
        serve_cases[key] = dict(
            arch=arch, changes=changes, params=_port_params(arch, changes),
            prompts=prompts, new_tokens=new)
        cfg = r_arch(arch)
        if cfg.is_encdec:
            serve_cases[key]["audio"] = _audio(cfg, batch)
    for key, (arch, changes) in GRAD.items():
        grad_cases[key] = dict(
            arch=arch, changes=changes, params=_port_params(arch, changes),
            batch=_grad_batch(r_arch(arch)))
    for arch in TRAIN:
        rspec = specs[arch] = _train_spec(arch)
        train_cases[arch] = dict(
            spec_json=_train_spec(arch, mesh="x".join(map(str, MESH)))
            .to_json(),
            init=_port_params(arch, {}), batches=_port_batches(rspec),
            resume_dir=(str(tmp_path_factory.mktemp("tp"))
                        if arch == TRAIN[0] else None),
            cost_path=(str(tmp_path_factory.mktemp("cost") / "m.prom")
                       if arch == TRAIN[0] else None),
            seq_shard=arch in SEQ_SHARDED)

    head_cases = {}
    for key, (arch, changes) in HEADS.items():
        cfg = dataclasses.replace(r_arch(arch), **changes)
        head_cases[key] = dict(
            arch=arch, changes=changes, params=_port_params(arch, changes),
            batch=_grad_batch(cfg), prompts=_prompts(arch, changes, 2, 8))
    spec_case, spec_ref = _stream_spec_case()

    def world_then_cli():
        ranks = spawn(tp_rank, MESH[0] * MESH[1], serve_cases, train_cases,
                      grad_cases, CLI, head_cases, STREAM, spec_case)
        return ranks, _cli_mesh(CLI, "2x1")

    # this process's torch work is small ops; on a loaded machine a pool
    # of every core makes each op wait for all of them (the one-process
    # streaming runs took 12 times as long), so it runs on one thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(world_then_cli)
            want = {key: _reference_serving(
                case["arch"], case["changes"], case["prompts"],
                SERVE[key][4], case["params"], case["new_tokens"])
                for key, case in serve_cases.items()}
            for key, case in serve_cases.items():
                if "audio" in case:
                    want[key]["audio"] = _reference_audio(
                        case["arch"], case["changes"], case["params"],
                        case["prompts"], case["audio"],
                        case["prompts"].shape[1] + case["new_tokens"])
            for key, case in grad_cases.items():
                want["grad", key] = _reference_grad(
                    case["arch"], case["changes"], case["params"],
                    case["batch"])
            for arch, case in train_cases.items():
                ref = _reference_run(specs[arch], case["init"],
                                     case["batches"])
                want[arch] = ([r["loss"] for r in ref.history],
                              _flat(jax.tree.leaves(ref.params)),
                              case["init"],
                              _local_port_run(specs[arch], case["init"],
                                              case["batches"]))
            for key, case in head_cases.items():
                want["heads", key] = _heads_single(**case)
            for key, (kind, rule, attack, shape, steps) in STREAM.items():
                want["stream", key] = stream_single(kind, rule, attack,
                                                    shape[0], steps)
            want["spec"] = ([r["loss"] for r in spec_ref.history],
                            _flat(jax.tree.leaves(spec_ref.params)))
            ranks, cli = ranks.result()
    finally:
        torch.set_num_threads(threads)
    ranks[0]["cli"]["2x1"] = cli
    return want, ranks


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
    assert ("audio" in got) == ("audio" in want[key])
    if "audio" in got:
        np.testing.assert_allclose(got["audio"], want[key]["audio"],
                                   rtol=0, atol=1e-5)


def _cache_block_bytes(arch, changes, batch, total) -> int:
    """One rank's bytes of the reference's whole cache (its shapes, f32)
    cut on the (2, 2) mesh: the batch dim (dim 1 under a layer-stacked
    ``blocks``/``self``/``cross``, else dim 0) halved when the batch
    divides, the KV heads of ``k``/``v`` and the heads of the SSM state
    ``ssm`` halved when they divide (the SSM state's head cut is the
    port's own; the reference keeps those heads whole)."""
    rm = r_build(dataclasses.replace(r_arch(arch), **changes))
    cache = jax.eval_shape(lambda: rm.init_cache(batch, total))
    total_bytes = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        names = [k.key for k in path]
        shape = list(leaf.shape)
        off = 1 if names[0] in ("blocks", "self", "cross") else 0
        if shape[off] % MESH[0] == 0:
            shape[off] //= MESH[0]
        head = {"k": off + 2, "v": off + 2, "ssm": off + 1}.get(names[-1])
        if head is not None and len(shape) == off + 4 \
                and shape[head] % MESH[1] == 0:
            shape[head] //= MESH[1]
        total_bytes += int(np.prod(shape)) * 4
    return total_bytes


@pytest.mark.parametrize("key", list(SERVE))
def test_each_serving_rank_holds_only_its_cache_blocks(world, key):
    """Each rank's cache is its blocks: its requests' rows, its KV heads
    and its SSM state heads, counted in bytes."""
    _, ranks = world
    arch, changes, batch, plen, _, new = SERVE[key]
    want = _cache_block_bytes(arch, changes, batch, plen + new)
    for r in ranks:
        assert r["serve"][key]["cache_bytes"] == want


def _printed_tokens(out: str) -> np.ndarray:
    """The token matrix the serve CLI printed after its ``[serve] ...``
    line."""
    text = out.split("tok/s)\n", 1)[1]
    return np.array([int(t) for t in re.findall(r"-?\d+", text)])


def test_serve_cli_prints_the_same_tokens_on_the_mesh(world):
    """``launch.serve`` with whisper-large-v3-reduced at ``--batch 2
    --prompt-len 4 --new-tokens 2`` prints the reference's tokens for its
    prompts (``repro.serve.generate`` on the "whisper" serving case): alone,
    as a rank of the (2, 2) world with ``--mesh 2x2``, and with ``--mesh
    2x1`` from a process with no world (it spawns its 2 ranks; the
    requests over the data axis, the cache cut on its batch dim)."""
    want, ranks = world
    plen = SERVE[CLI_CASE][3]
    ref = want[CLI_CASE]["tokens"][:, plen:].ravel()
    cli = ranks[0]["cli"]
    for key in ("alone", "mesh", "2x1"):
        assert "whisper-large-v3-reduced" in cli[key]
        np.testing.assert_array_equal(_printed_tokens(cli[key]), ref)


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
              "deepseek-v2-lite-16b-reduced": 1e-5,
              "mamba2-2.7b-reduced": 1e-6, "hymba-1.5b-reduced": 1e-6}


@pytest.mark.parametrize("arch", TRAIN)
def test_mesh_training_matches_the_reference_trajectory(world, arch):
    """Three sync_ps steps on the (2, 2) mesh (tensor-parallel compute)
    against the reference's local run and the port's single-process run,
    all from the same params on the same batches."""
    want, ranks = world
    got = ranks[0]["train"][arch]
    assert got["tp"]
    losses, params, _, local = want[arch]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["params"], params, rtol=1e-4,
                               atol=PARAM_ATOL[arch])
    np.testing.assert_allclose(got["params"], local, rtol=1e-4,
                               atol=PARAM_ATOL[arch])


@pytest.mark.parametrize("arch", SEQ_SHARDED)
def test_seq_shard_trajectory_equals_the_run_without_it(world, arch):
    """With ``SEQ_SHARD`` the residual stream between layers is each
    model rank's half of the 8 positions (gathered into each mixer and
    FFN, reduce-scattered out of them): the same three steps as without
    it, at the trajectory tolerances above (losses rtol 1e-4; params
    rtol 1e-4 and the arch's atol)."""
    _, ranks = world
    got = ranks[0]["train"][arch]
    np.testing.assert_allclose(got["seq"]["losses"], got["losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["seq"]["params"], got["params"],
                               rtol=1e-4, atol=PARAM_ATOL[arch])


# One batch's gradient against the reference's: rtol 1e-4, atol 1e-6 (the
# trajectory tolerances above); internvl2 at atol 1e-5, since the port's
# own single-process gradient is 3.7e-6 from the reference's (3 of the
# embedding table's 131,072 entries, which carry the sqrt(d_model) scale
# of the embedding and the VLM loss's sum over the batch, up to 2.2); the
# loss at rtol 1e-5.
GRAD_ATOL = {"whisper": 1e-6, "internvl2": 1e-5, "mamba2 + tail": 1e-6}


@pytest.mark.parametrize("key", list(GRAD))
def test_mesh_gradient_matches_the_reference(world, key):
    """The loss and every leaf's gradient of one batch, from each rank's
    blocks (the gradient's blocks joined), against ``jax.value_and_grad``
    of the reference model's loss on the same numpy batch."""
    want, ranks = world
    got = ranks[0]["grad"][key]
    ref = want["grad", key]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    got_leaves = tree_util.leaves(got["grads"])
    ref_leaves = [np.asarray(x) for x in tree_util.leaves(ref["grads"])]
    assert len(got_leaves) == len(ref_leaves)
    for g, r in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=GRAD_ATOL[key])


@pytest.mark.parametrize("leaf", ["A_log", "D", "dt_bias", "conv_b",
                                  "scale"])
def test_whole_per_head_leaf_gets_the_whole_gradient(world, leaf):
    """The tail layer of the 3-layer mamba2 holds its per-head leaves
    (and ``conv_b``, and the gated norm's ``scale``) whole on each model
    rank, and each rank's heads use their part of it: summed over the
    model axis, its gradient is the reference's whole gradient (at the
    tolerances above), not one rank's part."""
    want, ranks = world
    got = ranks[0]["grad"]["mamba2 + tail"]
    ref = want["grad", "mamba2 + tail"]["grads"]["stack"]["tail0"]["mixer"]
    mine = got["grads"]["stack"]["tail0"]["mixer"]
    whole = got["whole"]["stack"]["tail0"]["mixer"]
    if leaf == "scale":
        mine, ref, whole = mine["norm"], ref["norm"], whole["norm"]
    assert whole[leaf]
    r = np.asarray(ref[leaf])
    half = r.shape[0] // MESH[1]
    assert np.abs(r[:half]).max() > 0 and np.abs(r[half:]).max() > 0
    np.testing.assert_allclose(mine[leaf], r, rtol=1e-4, atol=1e-6)


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


@pytest.mark.parametrize("key", list(HEADS))
def test_heads_that_do_not_split_match_the_single_process(world, key):
    """On the (1, 4) mesh: one batch's loss and every leaf's gradient
    (remat full; the blocks joined) at this file's gradient tolerances
    (rtol 1e-4, atol 1e-6), the serving step's prefill and first decode
    logits within 1e-5, of the single process's."""
    want, ranks = world
    got, ref = ranks[0]["heads"][key], want["heads", key]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for g, r in zip(tree_util.leaves(got["grads"]),
                    tree_util.leaves(ref["grads"])):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)
    for k in ("prefill", "decode"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5)


def _head_block(rank: int, H: int, Kv: int, tp: int) -> tuple:
    """(q heads, K/V heads) a rank attends over: its block of H padded to
    a multiple of tp, and the K/V heads its q heads read (each its own
    where the groups come out uneven); None for padding alone."""
    n = -(-H // tp)
    lo, hi = min(rank * n, H), min((rank + 1) * n, H)
    if hi <= lo:
        return None
    kv = [h // (H // Kv) for h in range(lo, hi)]
    even = all(kv.count(j) == len(kv) // len(set(kv)) for j in set(kv))
    return hi - lo, len(set(kv)) if even else hi - lo


@pytest.mark.parametrize("key", list(HEADS))
def test_each_rank_attends_over_its_head_block(world, key):
    """Every attention call of the loss (forward and remat recompute) on
    each rank of the (1, 4) mesh gets that rank's head block alone:
    granite's 4/2 one q head and its group's K/V head a rank; the 6/2
    model's heads padded to 8, two a rank (their K/V heads), the last
    rank none, so it attends over nothing."""
    _, ranks = world
    arch, changes = HEADS[key]
    cfg = dataclasses.replace(t_arch(arch), **changes)
    for r, rk in enumerate(ranks):
        want = _head_block(r, cfg.num_heads, cfg.num_kv_heads,
                           HEADS_MESH[1])
        seen = {tuple(x) for x in rk["heads"][key]["heads"]}
        assert seen == (set() if want is None else {want}), (r, seen)


def _phocas_ties(workers: np.ndarray, bad: np.ndarray) -> np.ndarray:
    """The phocas b = 1 boundary gap at coordinates ``bad`` of the (m, D)
    worker matrix: how much farther from the trimmed mean the farthest
    value lies than the next (0 at a distance tie, where the value that
    phocas drops flips with the rounding of the center)."""
    u = workers[:, bad].astype(np.float64)
    srt = np.sort(u, axis=0)
    center = srt[1:-1].mean(0)
    d = np.sort(np.abs(u - center), axis=0)
    return (d[-1] - d[-2]) / np.maximum(np.abs(u).max(0), 1e-30)


@pytest.mark.parametrize("key", [k for k in STREAM
                                 if k not in STREAM_BANDED])
def test_mesh_streaming_matches_the_single_process(world, key):
    """The FSDP streaming step on its mesh, step for step against the
    one-process streaming step from the same params on the same batches:
    params at rtol 1e-4, atol 1e-6 and the workers' losses at rtol 1e-4
    (``test_torch_streaming.py``'s).  Phocas is discontinuous at a
    distance tie, where the mesh's sums over the data ranks and the one
    process's round the center apart and flip the value dropped: a first
    step's coordinate past the tolerance must be such a tie (the gap
    under 1e-5 of the coordinate's largest value, as
    ``test_kernels.py::_assert_phocas_close`` allows), and a later step is
    held on the rest (a flip there moves the momentum); the MLP's steps
    meet no tie."""
    want, ranks = world
    got, ref = ranks[0]["stream"][key], want["stream", key]
    ok = None
    for a, b in zip(got["params"], ref["params"]):
        close = np.isclose(a, b, rtol=1e-4, atol=1e-6)
        if ok is None and "workers" in ref:
            bad = np.flatnonzero(~close)
            assert bad.size <= 4, bad.size
            assert (_phocas_ties(ref["workers"], bad) < 1e-5).all()
            ok = close
        np.testing.assert_allclose(a[ok] if ok is not None else a,
                                   b[ok] if ok is not None else b,
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.stack(got["losses"]),
                               np.stack(ref["losses"]), rtol=1e-4)


@pytest.mark.parametrize("key", STREAM_BANDED)
def test_mesh_streaming_gaussian_is_held_by_bands(world, key):
    """Under gaussian the shards draw their own noise (the single
    process's draws are not reproduced), so the runs are held by bands:
    the workers' losses within 1 % of the single process's, each step's
    update as long within 5 % (L2), and pointing the same way (cosine
    above 0.99)."""
    want, ranks = world
    got, ref = ranks[0]["stream"][key], want["stream", key]
    np.testing.assert_allclose(np.stack(got["losses"]),
                               np.stack(ref["losses"]), rtol=1e-2)
    start = _port_stream_init(key)
    for a, b in zip(got["params"], ref["params"]):
        da, db = a - start, b - start
        na, nb = np.linalg.norm(da), np.linalg.norm(db)
        assert abs(na / nb - 1) <= 0.05, (na, nb)
        assert float(da @ db) / (na * nb) >= 0.99
        start = b


def _port_stream_init(key) -> np.ndarray:
    from torch_tp_ranks import stream_setup
    model, _ = stream_setup(STREAM[key][0], STREAM[key][3][0])
    return _flat(x.numpy() for x in tree_util.leaves(
        model.init(torch.Generator().manual_seed(0))))


@pytest.mark.parametrize("key", [k for k in STREAM if k.startswith("gemma2")])
def test_each_streaming_rank_holds_a_quarter(world, key):
    """Every rank of the 4-rank world holds a quarter of gemma2's params,
    of its momentum and (b = 1) of the bottom statistic over the
    workers' f32 gradients: its FSDP shards (every leaf cuts 4 ways)."""
    _, ranks = world
    for rk in ranks:
        for what, (mine, whole) in rk["stream"][key]["bytes"].items():
            assert 4 * mine == whole, (what, mine, whole)


def test_mesh_streaming_topology_matches_the_reference(world):
    """The ``streaming`` topology on a (4, 1) mesh (the spec's plan given
    the mesh; the MLP, m = 4, phocas b = 1 under signflip) from the
    reference's params on its batches equals the reference's
    ``run_experiment`` of the spec (no mesh): losses at rtol 1e-4, params
    at rtol 1e-4, atol 1e-6."""
    want, ranks = world
    losses, params = want["spec"]
    got = ranks[0]["spec"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["params"], params, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# The NCCL collective forms, on the gloo world
# ---------------------------------------------------------------------------

def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value of ``x`` (8 significand bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _nccl_ops(world, reduce_scatter: bool) -> list:
    """(rank, op, (NCCL forms' output, gloo forms' output)) of every rank's
    reduce-scatters, or of its other collectives."""
    _, ranks = world
    return [(r, key, pair) for r, rk in enumerate(ranks)
            for key, pair in rk["nccl"]["ops"].items()
            if key.startswith("reduce_scatter") == reduce_scatter]


def test_nccl_gathers_and_all_to_alls_equal_the_gloo_forms(world):
    """On every rank, each all_gather (dims 0 and 1 over both axes, the
    worker gather, the model-axis gather of the tensor-parallel layers) and
    the two-axis all_to_all give the gloo forms' bits; the gathers went
    through ``all_gather_single``."""
    cases = _nccl_ops(world, False)
    assert len(cases) == 5 * MESH[0] * MESH[1]
    for rank, key, (nccl, gloo) in cases:
        np.testing.assert_array_equal(nccl, gloo, err_msg=f"{key} {rank}")
    assert world[1][0]["nccl"]["calls"]["all_gather_single"] > 0


def test_nccl_reduce_scatter_equals_all_reduce_then_cut(world):
    """``reduce_scatter_to_model`` over the model axis (dims 0 and 1) and
    over both axes (dim 2): one ``reduce_scatter_single`` an axis under the
    NCCL forms against the gloo forms' f32 all_reduce and cut, within rtol
    1e-6 in f32 and one bf16 ulp in bf16 (both sum in f32 and round
    once)."""
    cases = _nccl_ops(world, True)
    assert len(cases) == 6 * MESH[0] * MESH[1]
    for rank, key, (nccl, gloo) in cases:
        assert nccl.shape == gloo.shape, key
        if "bfloat16" in key:
            assert (np.abs(nccl - gloo) <= _bf16_ulp(gloo)).all(), key
        else:
            np.testing.assert_allclose(nccl, gloo, rtol=1e-6, atol=0,
                                       err_msg=f"{key} {rank}")
    assert world[1][0]["nccl"]["calls"]["reduce_scatter_single"] > 0


def test_nccl_forms_seq_shard_run_matches_gloo_and_the_reference(world):
    """gemma2-2b-reduced's three ``SEQ_SHARD`` steps on the NCCL-form
    (2, 2) mesh (reduce-scatters out of every mixer and FFN) against the
    gloo forms' run (losses rtol 1e-5; params rtol 1e-5, atol 1e-7) and
    the reference's trajectory at the tolerances above."""
    want, ranks = world
    got = ranks[0]["nccl"]["train"]
    gloo = ranks[0]["train"][NCCL_TRAIN]["seq"]
    np.testing.assert_allclose(got["losses"], gloo["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], gloo["params"], rtol=1e-5,
                               atol=1e-7)
    losses, params, _, _ = want[NCCL_TRAIN]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["params"], params, rtol=1e-4,
                               atol=PARAM_ATOL[NCCL_TRAIN])


def test_nccl_forms_fsdp_streaming_step_matches_gloo_and_the_reference(
        world):
    """The MLP's FSDP streaming steps on the NCCL-form (4, 1) mesh (its
    gradient reduce-scattered over the data axis) against the gloo forms'
    (losses rtol 1e-5; params rtol 1e-5, atol 1e-7) and the one-process
    streaming step at ``test_mesh_streaming_matches_the_single_process``'s
    tolerances."""
    want, ranks = world
    got = ranks[0]["nccl"]["stream"]
    gloo = ranks[0]["stream"][NCCL_STREAM]
    ref = want["stream", NCCL_STREAM]
    for a, b, r in zip(got["params"], gloo["params"], ref["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.stack(got["losses"]),
                               np.stack(gloo["losses"]), rtol=1e-5)
    np.testing.assert_allclose(np.stack(got["losses"]),
                               np.stack(ref["losses"]), rtol=1e-4)
