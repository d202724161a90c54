"""Serving runtime (port of ``repro/serve/engine.py``, DESIGN.md §11).

Two tiers:

* The **dense tier** (``make_serve_step`` / ``generate``): static-batch
  greedy decode over the ring cache, with a batched prefill (one forward
  pass writes the whole prompt); :func:`generate_stepwise` steps the prompt
  token by token and is the regression oracle.

* The **paged tier** (:class:`ServeEngine`): paged KV cache with
  per-request block tables (``serve/cache.py``), continuous batching with
  admission control (``serve/scheduler.py``), and optional k-replica
  Byzantine-robust decode (``serve/robust_decode.py``).  Every decode step
  is one fixed-shape call over all ``max_slots`` slots — inactive slots
  write to the reserved trash block and their outputs are ignored.
  Prefills are grouped by prompt length and each group's batch is padded to
  a power of two, as in the reference.

The reference donates the KV pool to its jitted steps.  Here the steps
write the pool in place (``index_put_`` on each layer's k/v block pool) and
hand the same tensors back.  PyTorch runs eagerly: there is no compile, and
the step functions are plain closures.

On a (data, model) mesh (a ``dist/mesh.py::HostMesh`` over a world, one
rank per device) the dense tier runs as one rank of the mesh:
``shard_params`` and ``shard_cache`` cut the params and the cache to this
rank's blocks (``dist/sharding.py``: the request batch over the worker
axes when it divides, on each cache leaf's own batch dim; the KV heads
and the SSM state's heads over the model axes when they divide), the step
runs under ``use_mesh``, so every family's layers (dense, MoE, MLA, SSM,
hybrid, enc-dec, VLM) compute tensor-parallel on the blocks, and the
tokens are all_gathered over the data axis at the end.  The paged tier
takes no mesh, as the reference's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.dist.mesh import use_mesh
from repro_torch.dist.sharding import (shard_cache, shard_params,
                                       worker_axes_of)
from repro_torch.serve.cache import BLOCK_TOKENS, PagedKVCache
from repro_torch.serve.robust_decode import RobustDecoder
from repro_torch.serve.scheduler import DECODE, Request, Scheduler


def make_serve_step(model, *, mesh=None, batch_sharded: bool = False,
                    fsdp=None):
    """Returns ``serve_step(params, cache, tokens, pos) -> (next_tokens,
    logits, cache)``.  With tokens (B,1) and an int pos it is one decode
    step; with tokens (B,S0) and pos = arange(S0) it is a batched prefill
    whose next_tokens continue the prompt.  With ``mesh`` the step runs
    under ``use_mesh`` on this rank's blocks (with ``fsdp``, an
    ``FsdpLayout``, on its FSDP shards); ``batch_sharded`` says the
    tokens are this rank's rows of a batch sharded over the worker axes."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits[:, -1].argmax(-1)[:, None], logits, cache

    if mesh is None:
        return serve_step

    def stepped(params, cache, tokens, pos):
        with use_mesh(mesh, batch_sharded=batch_sharded, fsdp=fsdp):
            return serve_step(params, cache, tokens, pos)

    return stepped


class MeshServing:
    """How the dense tier serves ``model`` (an arch model, which computes
    tensor-parallel) on ``mesh``: this rank's rows of a batch of B, its
    blocks of the params and cache, and the step."""

    def __init__(self, model, mesh, batch: int):
        self.mesh, self.model = mesh, model
        self.worker_axes = mesh.axes(worker_axes_of(mesh))
        from repro_torch.dist.collectives import (axis_size,
                                                  worker_slice_index)
        d = axis_size(self.worker_axes)
        self.sharded = d > 1 and batch % d == 0
        n = batch // d if self.sharded else batch
        start = worker_slice_index(self.worker_axes) * n if self.sharded \
            else 0
        self.rows = slice(start, start + n)

    def params(self, params):
        return shard_params(params, self.mesh,
                            full=self.model.abstract_params())

    def cache(self, batch: int, total: int, device):
        return shard_cache(self.model.init_cache(batch, total, device),
                           self.mesh)

    def step(self, fsdp=None):
        return make_serve_step(self.model, mesh=self.mesh,
                               batch_sharded=self.sharded, fsdp=fsdp)

    def gather(self, toks):
        from repro_torch.dist.collectives import all_gather_axes
        return all_gather_axes(toks, self.worker_axes, 0) if self.sharded \
            else toks


def batched_prefill_supported(cfg, prompt_len: int) -> bool:
    """Whether one decode_step call can prefill a (B, prompt_len) prompt:
    recurrent state (SSM/hybrid) steps by construction, enc-dec prefills in
    its own forward, and windowed ring buffers only hold prompt_len <= W."""
    if cfg.is_ssm or cfg.hybrid or cfg.is_encdec:
        return False
    return all(w is None or prompt_len <= w for w in cfg.layer_windows())


def generate(model, params, prompts: torch.Tensor, max_new_tokens: int,
             *, max_len: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Greedy batched generation.  prompts: (B, S0) integer tensor on the
    params' device.  Prefills the whole prompt in one forward pass when the
    architecture allows it (else the stepwise loop), then decodes greedily.
    Returns (B, S0 + max_new_tokens) int64.

    With ``mesh`` (a ``HostMesh`` over the world) this process is one rank:
    ``params`` are the whole tree or this rank's blocks (``shard_params``),
    ``prompts`` the whole batch; every rank returns the whole batch's
    tokens.

    The prefill and each decode step run inside ``prefill``/``decode``
    spans of the process-default Recorder (``obs.set_default_recorder``,
    which the serve CLI sets under ``--metrics``; no-ops otherwise)."""
    from repro_torch.obs.trace import span
    B, S0 = prompts.shape
    total = S0 + max_new_tokens if max_len is None else max_len
    if not (S0 > 1 and batched_prefill_supported(model.cfg, S0)):
        return generate_stepwise(model, params, prompts, max_new_tokens,
                                 max_len=max_len, mesh=mesh)
    prompts = prompts.long()
    ms = None if mesh is None else MeshServing(model, mesh, B)
    if ms is not None:
        params, prompts = ms.params(params), prompts[ms.rows]
        cache = ms.cache(B, total, prompts.device)
        step = ms.step()
    else:
        cache = model.init_cache(B, total, prompts.device)
        step = make_serve_step(model)
    with span("prefill", step_num=0, prompt_len=S0, batch=B) as sp:
        nxt, _, cache = sp.sync(step(params, cache, prompts,
                                     torch.arange(S0,
                                                  device=prompts.device)))
    toks = torch.cat([prompts, nxt], dim=1)
    t = S0
    while toks.shape[1] < total:
        with span("decode", step_num=t - S0 + 1, batch=B) as sp:
            nxt, _, cache = sp.sync(step(params, cache, nxt, t))
        toks = torch.cat([toks, nxt], dim=1)
        t += 1
    return toks if ms is None else ms.gather(toks)


def generate_stepwise(model, params, prompts: torch.Tensor,
                      max_new_tokens: int, *, max_len: Optional[int] = None,
                      mesh=None) -> torch.Tensor:
    """Step the prompt token by token, then decode greedily: the fallback
    for architectures batched prefill cannot cover and the oracle
    :func:`generate` is held to.  ``mesh`` as in :func:`generate`."""
    B, S0 = prompts.shape
    total = S0 + max_new_tokens if max_len is None else max_len
    prompts = prompts.long()
    ms = None if mesh is None else MeshServing(model, mesh, B)
    if ms is not None:
        params, prompts = ms.params(params), prompts[ms.rows]
        cache = ms.cache(B, total, prompts.device)
        step = ms.step()
    else:
        cache = model.init_cache(B, total, prompts.device)
        step = make_serve_step(model)
    toks = prompts
    nxt = prompts[:, :1]
    for t in range(total - 1):
        cur = toks[:, t:t + 1] if t < S0 else nxt
        nxt, _, cache = step(params, cache, cur, t)
        if t >= S0 - 1:
            toks = torch.cat([toks, nxt], dim=1)
        if toks.shape[1] >= total:
            break
    return toks if ms is None else ms.gather(toks)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ServeEngine:
    """Continuous-batching paged-cache serving engine.

    ``params`` is the model's params tree — or, when ``decoder`` is given,
    the length-``decoder.k`` tuple of per-replica trees from
    ``robust_decode.make_replicas``.  The cache lives on the parameters'
    device.  ``submit()`` enqueues requests; each ``step()`` retires
    finished requests, admits queued ones (slot + cache-footprint gates),
    prefills joiners, and runs one decode step over every active slot.
    ``run()`` loops until drained.
    """

    def __init__(self, model, params, *, max_slots: int = 8,
                 max_seq_len: int = 256,
                 block_tokens: int = BLOCK_TOKENS,
                 num_blocks: Optional[int] = None,
                 decoder: Optional[RobustDecoder] = None,
                 telemetry=None):
        if not model.supports_paged:
            raise NotImplementedError(
                f"arch {model.cfg.name!r} is not paged-serving capable "
                "(see models.stack.paged_supported); use serve.generate")
        if decoder is not None and (not isinstance(params, tuple)
                                    or len(params) != decoder.k):
            raise ValueError(
                f"replicated decode needs params as a length-{decoder.k} "
                "tuple of per-replica trees (see "
                "robust_decode.make_replicas)")
        self.model = model
        self.params = params
        self.decoder = decoder
        self.device = tree_util.leaves(params)[0].device
        from repro_torch.obs.metrics import as_recorder
        self.obs = as_recorder(telemetry)
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.cache = PagedKVCache(
            model, max_slots=max_slots, max_seq_len=max_seq_len,
            block_tokens=block_tokens, num_blocks=num_blocks,
            replicas=decoder.k if decoder is not None else 1,
            device=self.device)
        self.pool = self.cache.pool
        self.scheduler = Scheduler(
            max_slots=max_slots,
            can_cover=self.cache.can_cover,
            reserve=self.cache.ensure,
            release=self.cache.release)
        self.steps_run = 0
        self._build_steps()

    # -- device steps ----------------------------------------------------------

    def _build_steps(self):
        model = self.model
        if self.decoder is None:
            def prefill(params, pool, tokens, tables):
                logits, pool = model.prefill_paged(params, pool, tokens,
                                                   tables)
                return logits[:, -1].argmax(-1), pool

            def decode(params, pool, tokens, positions, tables, rep_state):
                logits, pool = model.decode_step_paged(
                    params, pool, tokens, positions, tables)
                return (logits[:, -1].argmax(-1), pool, rep_state,
                        torch.zeros((1,), device=tokens.device))
        else:
            dec = self.decoder

            # params/pool are TUPLES of per-replica trees; the loops run k
            # forwards one after the other.
            def prefill(params, pool, tokens, tables):
                last = []
                for p, c in zip(params, pool):
                    logits, _ = model.prefill_paged(p, c, tokens, tables)
                    last.append(logits[:, -1].float())
                stacked = torch.stack(last)                 # (k, B, V)
                k, B, V = stacked.shape
                # Aggregate through the current gate; reputation updates
                # stay on the homogeneous decode step (prefill batches are
                # partial and variable-shaped).
                agg, _ = dec.rule.reduce_gated_with_scores(
                    stacked.reshape(k, B * V), dec.rep_state["active"])
                return agg.reshape(B, V).argmax(-1), pool

            def decode(params, pool, tokens, positions, tables, rep_state):
                last = []
                for p, c in zip(params, pool):
                    logits, _ = model.decode_step_paged(
                        p, c, tokens, positions, tables)
                    last.append(logits[:, -1])
                agg, scores, new_state = dec.aggregate(
                    torch.stack(last), rep_state)
                return agg.argmax(-1), pool, new_state, scores

        self._prefill_fn = prefill
        self._decode_fn = decode

    # -- request API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               deadline_s: float = 0.0) -> Request:
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request needs {len(prompt) + max_new_tokens} positions, "
                f"engine max_seq_len={self.max_seq_len}")
        return self.scheduler.submit(prompt, max_new_tokens,
                                     deadline_s=deadline_s)

    def cancel(self, req: Request) -> bool:
        """Cancel a request (client disconnect): frees its slot and KV
        reservation immediately so the next admit() can reuse them."""
        ok = self.scheduler.cancel(req)
        if ok:
            self.obs.count("serve_cancelled")
        return ok

    # -- degradation -----------------------------------------------------------

    def crash_replica(self, index: int) -> None:
        """Simulate replica ``index``'s host dying mid-serve: its params and
        KV pool are dropped and the decoder shrinks to the surviving k-1
        replicas with b re-resolved.  In-flight requests continue — the
        block tables and survivor pools are untouched."""
        if self.decoder is None:
            raise ValueError(
                "crash_replica needs replicated robust decode "
                "(ServeEngine(decoder=...))")
        self.decoder.shrink(index)        # validates index, k >= 3
        self.params = tuple(p for i, p in enumerate(self.params)
                            if i != index)
        self.pool = tuple(c for i, c in enumerate(self.pool) if i != index)
        self._build_steps()
        self.obs.count("replica_crashes")

    # -- the loop --------------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def step(self) -> int:
        """One engine iteration: retire -> admit -> prefill joiners -> one
        batched decode over every active slot.  Returns the number of
        tokens generated this step."""
        sched = self.scheduler
        obs = self.obs
        expired = sched.expire_deadlines()
        if expired:
            obs.count("serve_deadline_expired", len(expired))
        retired = sched.retire_finished()
        admitted = sched.admit()
        if retired:
            obs.count("serve_retired", len(retired))
        if admitted:
            obs.count("serve_admitted", len(admitted))
        if sched.queued and len(sched.active) < self.max_slots:
            obs.count("serve_outofblocks_averted")
        produced = 0

        # Batched prefill, grouped by prompt length, each group padded to a
        # power of two.
        by_len: dict = {}
        for req in admitted:
            by_len.setdefault(req.prompt_len, []).append(req)
        for S0, group in sorted(by_len.items()):
            tokens = np.zeros((_pow2(len(group)), S0), np.int64)
            tables = np.zeros((tokens.shape[0], self.cache.max_blocks),
                              np.int64)
            for i, req in enumerate(group):
                tokens[i] = req.prompt
                tables[i] = self.cache.tables[req.slot]
            with obs.span("prefill", step_num=self.steps_run,
                          prompt_len=S0, batch=tokens.shape[0]) as sp:
                nxt, self.pool = sp.sync(self._prefill_fn(
                    self.params, self.pool, self._tensor(tokens),
                    self._tensor(tables)))
            nxt = nxt.tolist()
            for i, req in enumerate(group):
                sched.mark_decoding(req, nxt[i])
                produced += 1

        # One fixed-shape decode step over all slots (inactive slots carry
        # zero tokens/positions and all-zero table rows -> trash block).
        decoding = [r for r in sched.active if r.state == DECODE
                    and not r.finished]
        if decoding:
            tokens = np.zeros((self.max_slots, 1), np.int64)
            positions = np.zeros((self.max_slots,), np.int64)
            for req in decoding:
                tokens[req.slot, 0] = req.generated[-1]
                positions[req.slot] = req.decode_pos
            rep = (self.decoder.rep_state if self.decoder is not None
                   else {})
            k = self.decoder.k if self.decoder is not None else 1
            with obs.span("decode", step_num=self.steps_run,
                          slots=len(decoding), k=k) as sp:
                nxt, self.pool, new_rep, scores = sp.sync(self._decode_fn(
                    self.params, self.pool, self._tensor(tokens),
                    self._tensor(positions), self.cache.device_tables(),
                    rep))
            nxt = nxt.tolist()
            for req in decoding:
                sched.append_token(req, nxt[req.slot])
                produced += 1
            if self.decoder is not None:
                self.decoder.observe(new_rep, scores,
                                     telemetry=obs,
                                     step=self.steps_run)
        obs.log("serve", self.steps_run, active=len(sched.active),
                queued=sched.queued, produced=produced,
                free_blocks=self.cache.allocator.free_blocks)
        self.steps_run += 1
        return produced

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Drive ``step()`` until every submitted request completed."""
        for _ in range(max_steps):
            if not self.scheduler.busy:
                break
            self.step()
        self.scheduler.retire_finished()
        return list(self.scheduler.completed)

    # -- measurement -----------------------------------------------------------

    def time_decode_step(self, iters: int = 20) -> float:
        """Median wall-time (ms) of the all-slots decode call at the
        engine's current occupancy, synchronized on a CUDA device (idle
        slots write the trash block; the pool's other contents are
        unchanged)."""
        import time
        tokens = torch.zeros((self.max_slots, 1), dtype=torch.long,
                             device=self.device)
        positions = torch.zeros((self.max_slots,), dtype=torch.long,
                                device=self.device)
        tables = self.cache.device_tables()
        rep = self.decoder.rep_state if self.decoder is not None else {}

        def once():
            nxt, self.pool, _, _ = self._decode_fn(
                self.params, self.pool, tokens, positions, tables, rep)
            if nxt.is_cuda:
                torch.cuda.synchronize(nxt.device)

        once()                                                 # warm-up
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            once()
            samples.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(samples))
