"""Byzantine-resilient synchronous-SGD train step (the paper's PS loop).

Port of ``repro/train/step.py::make_train_step``:

  1. the batch arrives as (m, B/m, ...) worker groups, one per paper worker;
  2. per-worker losses and gradients come from ``torch.func.vmap`` of
     ``grad_and_value`` over the group axis (the m estimates must survive
     to the aggregation stage, so nothing is summed here), inside the MoE's
     ``no_data_grouping`` as in the reference;
  3. the attack corrupts the (m, D) worker-gradient matrix and the robust
     rule aggregates it (``core/robust.py::aggregate_stacked_tree``); with a
     defense config the rule also scores every worker, the aggregate skips
     the ejected ones, and the reputation state and q̂ are updated; with a
     compression config the matrix goes through the codec wire model
     (``compress/pipeline.py``: encode, wire attack, decode) before the rule;
  4. the optimizer applies the aggregate.

On a mesh (``mesh``, a :class:`repro_torch.dist.mesh.HostMesh`) this process
is one rank: it computes the gradient of its own worker group,
``batch[worker_slice_index]``, on its blocks of the leaves that
``tree_pspecs`` shards over the model axes (a replicated leaf whole, as the
reference's ``P(worker_axes, *pspec)`` in_specs give it), and aggregates
through ``core/robust.py::robust_aggregate_dist`` in the config's layout.
Two computes, and the step prints on rank 0 which one it runs:

- tensor-parallel (:attr:`Model.tensor_parallel` models, every arch
  family: dense and MoE decoders with GQA or MLA, the SSM, the hybrid,
  whisper's encoder-decoder and the VLM, on a model axis > 1): the params
  and the optimizer state stay cut to this rank's blocks across steps
  (:class:`MeshParams` cuts and joins them); the forward and backward pass
  run under ``use_mesh`` on the blocks, so they give the gradient's blocks
  in ``tree_pspecs``' layout (a whole leaf's whole gradient, summed over
  the model ranks where each uses a part of it), and the optimizer
  updates the blocks.  The Megatron operators of ``dist/collectives.py``
  have no vmap rule, so the rank's one worker group goes through
  ``torch.func.grad_and_value`` without the worker ``vmap``;
- replicated (the paper's MLP and CNN, which have no ``cfg``, or a model
  axis of 1): the params are whole on every rank, the forward and backward
  pass run whole, each model-sharded leaf of the gradient is cut to this
  rank's block for the aggregation and the aggregate's blocks are
  all_gathered over the model axes, so the optimizer sees the whole
  aggregate on every rank.

Either way the values are the reference's, a replicated leaf's whole
gradient counted on every model rank included (ROADMAP queue 3).
"""
from __future__ import annotations

import torch

from repro_torch.compress.pipeline import aggregate_compressed_tree
from repro_torch.compress.spec import make_codec
from repro_torch import tree as tree_util
from repro_torch.core.robust import (RobustConfig, aggregate_stacked_tree,
                                     robust_aggregate_dist)
from repro_torch.models.moe import no_data_grouping
from repro_torch.optim.optimizers import OptConfig, apply_updates, tree_norm


class MeshParams:
    """Where a mesh step keeps ``model``'s params and optimizer state: cut
    to this rank's blocks when the step computes tensor-parallel
    (``tp``), whole otherwise.  ``shard``/``join`` move a params-shaped
    tree (or an optimizer state, whose ``step`` count stays as it is)
    between the two; ``norm`` is the whole tree's L2 norm from the
    blocks."""

    def __init__(self, model, mesh):
        from repro_torch.dist.collectives import axis_size, model_cuts
        from repro_torch.dist.sharding import model_axes_of
        self.mesh = mesh
        self.model_axes = mesh.axes(model_axes_of(mesh))
        self.tp = (getattr(model, "tensor_parallel", False)
                   and axis_size(self.model_axes) > 1)
        if self.tp:
            self.full = model.abstract_params()
            self.cuts = model_cuts(self.full, mesh)

    def _each(self, fn, tree):
        if isinstance(tree, dict) and "step" in tree:
            return {k: (v if k == "step" else fn(v)) for k, v in tree.items()}
        return fn(tree)

    def shard(self, tree):
        """This rank's blocks of a whole tree (a leaf that already is its
        block passes as it is)."""
        if not self.tp:
            return tree
        from repro_torch.dist.sharding import shard_params
        return self._each(lambda t: shard_params(t, self.mesh, self.full),
                          tree)

    def join(self, tree):
        """The whole tree from every model rank's blocks (a collective)."""
        if not self.tp:
            return tree
        from repro_torch.dist.collectives import join_blocks
        return self._each(lambda t: join_blocks(t, self.cuts), tree)

    def norm(self, tree) -> torch.Tensor:
        if not self.tp:
            return tree_norm(tree)
        from repro_torch.dist.collectives import psum_axes
        sq = [torch.sum(torch.square(x.float()))
              for x in tree_util.leaves(tree)]
        zero = torch.zeros((), device=sq[0].device)
        cut = sum((q for q, c in zip(sq, self.cuts) if c is not None), zero)
        whole = sum((q for q, c in zip(sq, self.cuts) if c is None), zero)
        return torch.sqrt(psum_axes(cut, self.model_axes) + whole)


def make_train_step(model, *, robust_cfg: RobustConfig, opt_cfg: OptConfig,
                    num_workers: int, mesh=None, defense_cfg=None,
                    compress_cfg=None):
    """Build the train step; batch leaves are worker-stacked (m, B/m, ...)
    and ``gen`` draws the random attacks' noise.  ``mesh`` (a ``HostMesh``
    over the live world, whose worker axes hold ``num_workers`` ranks) makes
    this process one rank of the distributed step; None aggregates locally.

    Without defense: ``step(params, opt_state, batch, gen) -> (params,
    opt_state, metrics)``.  With a ``repro_torch.defense.DefenseConfig``:
    ``step(params, opt_state, batch, gen, defense) -> (params, opt_state,
    defense, metrics)``, where ``defense`` is the reputation state and the
    metrics gain ``suspicion``, ``reputation``, ``active`` and ``q_hat``.
    With a ``repro_torch.compress.CompressionSpec`` the step also threads
    the codec's error-feedback residual as its trailing argument and
    trailing extra return: ``step(params, opt_state, batch, gen[, defense],
    resid)``, seeded with ``codec.init_state(m, D, device)``.
    """
    m = num_workers
    codec = make_codec(compress_cfg)
    worker_grads = torch.func.vmap(torch.func.grad_and_value(model.loss),
                                   in_dims=(None, 0))

    def grads_of(params, batch):
        groups = tree_util.leaves(batch)[0].shape[0]
        if groups != m:
            raise ValueError(f"batch has {groups} worker groups, expected "
                             f"m={m}")
        with no_data_grouping():
            return worker_grads(params, batch)

    def aggregate(grads, gen, active, with_scores, train_step):
        return aggregate_stacked_tree(grads, robust_cfg, gen, active=active,
                                      with_scores=with_scores,
                                      step=train_step)

    norm = tree_norm
    if mesh is not None:
        if codec is not None:
            raise ValueError(
                "gradient compression encodes whole worker rows and cannot "
                "run under a dim-sharded mesh; pass mesh=None")
        grads_of, aggregate, norm = _mesh_stages(
            mesh, robust_cfg, m, worker_grads, model)

    def step(params, opt_state, batch, gen):
        grads, losses = grads_of(params, batch)
        agg = aggregate(grads, gen, None, False, opt_state["step"])
        del grads
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state,
                                          norm=norm)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": norm(agg)}
        return params, opt_state, metrics

    def defense_step(params, opt_state, batch, gen, defense):
        from repro_torch.defense.detector import estimate_q
        from repro_torch.defense.reputation import update_reputation
        grads, losses = grads_of(params, batch)
        agg, scores = aggregate(grads, gen, defense["active"], True,
                                opt_state["step"])
        del grads
        defense = update_reputation(defense, scores, defense_cfg)
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state,
                                          norm=norm)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": norm(agg),
                   "suspicion": scores,
                   "reputation": defense["reputation"],
                   "active": defense["active"],
                   "q_hat": estimate_q(
                       scores, min_gap=defense_cfg.detector_min_gap)}
        return params, opt_state, defense, metrics

    def compress_step(params, opt_state, batch, gen, resid):
        grads, losses = grads_of(params, batch)
        agg, resid = aggregate_compressed_tree(
            grads, robust_cfg, codec, resid, gen, step=opt_state["step"])
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state,
                                          norm=norm)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": norm(agg)}
        return params, opt_state, resid, metrics

    def compress_defense_step(params, opt_state, batch, gen, defense, resid):
        from repro_torch.defense.detector import estimate_q
        from repro_torch.defense.reputation import update_reputation
        grads, losses = grads_of(params, batch)
        agg, scores, resid = aggregate_compressed_tree(
            grads, robust_cfg, codec, resid, gen, active=defense["active"],
            with_scores=True, step=opt_state["step"])
        defense = update_reputation(defense, scores, defense_cfg)
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state,
                                          norm=norm)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": norm(agg),
                   "suspicion": scores,
                   "reputation": defense["reputation"],
                   "active": defense["active"],
                   "q_hat": estimate_q(
                       scores, min_gap=defense_cfg.detector_min_gap)}
        return params, opt_state, defense, resid, metrics

    if codec is not None:
        return compress_step if defense_cfg is None else compress_defense_step
    return step if defense_cfg is None else defense_step


def _mesh_stages(mesh, robust_cfg: RobustConfig, m: int, worker_grads,
                 model):
    """The mesh step's ``(grads_of, aggregate, norm)``: this rank's worker
    gradient (and every worker's loss), its robust aggregation, and the
    aggregate's norm."""
    from repro_torch.dist.collectives import (all_gather_axes, axis_size,
                                              cut_to_blocks, join_blocks,
                                              model_cuts, worker_slice_index)
    from repro_torch.dist.mesh import use_mesh
    from repro_torch.dist.sharding import model_axes_of, worker_axes_of
    wa = mesh.axes(worker_axes_of(mesh))
    ma = mesh.axes(model_axes_of(mesh))
    if axis_size(wa) != m:
        raise ValueError(f"num_workers={m} != mesh worker axes size "
                         f"{axis_size(wa)}")
    widx = worker_slice_index(wa)
    layout = MeshParams(model, mesh)
    if mesh.rank == 0:
        name = model.cfg.name if model.cfg is not None else "the model"
        print(f"[mesh] {name} on {dict(mesh.shape)}: " + (
            "tensor-parallel compute on this rank's blocks" if layout.tp
            else "replicated compute (the whole forward and backward pass "
                 "on every rank of a model group)"))
    value_and_grad = torch.func.grad_and_value(model.loss)

    def check_groups(batch):
        groups = tree_util.leaves(batch)[0].shape[0]
        if groups != m:
            raise ValueError(f"batch has {groups} worker groups, expected "
                             f"m={m}")

    def tp_grads_of(params, batch):
        check_groups(batch)
        own = tree_util.map(lambda x: x[widx], batch)
        with use_mesh(mesh, batch_sharded=True), no_data_grouping():
            grads, loss = value_and_grad(params, own)
        return grads, all_gather_axes(loss[None], wa)

    def mesh_grads_of(params, batch):
        check_groups(batch)
        # Worker widx's group, as a stack of one through the local vmap.
        own = tree_util.map(lambda x: x[widx:widx + 1], batch)
        with no_data_grouping():
            grads, loss = worker_grads(params, own)
        return (tree_util.map(lambda g: g[0], grads),
                all_gather_axes(loss, wa))

    def aggregate(grads, gen, active, with_scores, train_step):
        cuts = None if layout.tp else model_cuts(grads, mesh)
        local = grads if layout.tp else cut_to_blocks(grads, cuts)
        out = robust_aggregate_dist(local, robust_cfg, wa, ma, gen,
                                    active=active, with_scores=with_scores,
                                    step=train_step)
        agg, scores = out if with_scores else (out, None)
        if not layout.tp:
            agg = join_blocks(agg, cuts)
        return (agg, scores) if with_scores else agg

    return (tp_grads_of if layout.tp else mesh_grads_of), aggregate, \
        layout.norm
