"""The data-parallel train step (port of ``repro.train.steps.make_train_step``).

Data parallelism runs as ``--mesh Dx1`` (or ``PxDx1``: P pods of D ranks)
in one of two modes, chosen by the group the step is given:

* ``SimGroup(D)`` (the default): all D ranks in one process on one device,
  the way the reference's tests hold 8 host devices in one process (its
  ``vmap`` simulation);
* ``DistGroup``: one rank per process over a ``torch.distributed`` group
  (the counterpart of the reference's per-device ``shard_map`` program);
  each process computes only its own rank's loss and gradients.

One step, for each rank ``w`` this process holds:

  1. rank ``w`` (pod-major over P x D) takes contiguous rows ``w`` of the
     global batch (every rank takes the whole batch when P x D does not
     divide it, as the reference replicates it) and computes its local
     loss and gradients;
  2. ``GradSync`` syncs the stacked ``[local, ...]`` gradients over the
     group: Zen on ``embed/table``, a psum on the rest (or, with
     ``compress``, Zen or a psum on each dense bucket's EF-sparsified
     payload), then ``/D``; on a two-level topology (``node_size > 1``)
     each bucket's plan runs inside each node, then across nodes; with
     pods the pods' results are averaged;
  3. global-norm clip and the AdamW or SGD update of the (replicated)
     parameters, on every process alike.

The optimizer state, ``step_fn.state``, is the reference's: ``{"leaves":
{name: moments}, "step": int}`` plus ``"residual"`` (the EF residuals,
``[local, S]`` f32 per compressed bucket) when the sync keeps one; it is
updated in place and can be checkpointed as it is.

``loss`` and the ``sync/*`` metrics are means over the whole group, the
same on every rank.  ``loss`` is the LM loss (``Model.train_loss``'s
``metrics["loss"]``); an MoE model differentiates it plus its weighted
load-balance loss, and its ``moe/*`` stats (each a mean over the layers)
join the metrics as group means too, as the reference's step merges
``train_loss``'s metrics.

Tensor parallelism and ZeRO-1 raise ``NotImplementedError``; ZeRO-1 is a
layout of the same elementwise update, so the full update here gives the
numbers of the reference's ZeRO-1 and ``--no-zero1`` runs alike.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.schemes import DistGroup, SimGroup
from repro_torch.core.topology import build_topology
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import INITS, UPDATES, OptConfig


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    opt: OptConfig = OptConfig()
    sync: SyncConfig = SyncConfig()
    zero1: bool = False


def make_gradsync(model: Model, tcfg: TrainerConfig, n_data: int,
                  group: SimGroup | DistGroup,
                  sparsity_profiles: dict | None = None, *,
                  node_size: int = 1, pods: int = 1) -> GradSync:
    """The trainer's GradSync over ``group``, built offline from the
    per-rank grad shapes and dtypes (the parameters': parameters are
    replicated).  ``sparsity_profiles`` ({leaf name or bucket key:
    SparsityProfile}) feeds measured density curves into the ``auto``
    scheme's per-bucket choice.  The data-parallel topology is
    ``build_topology(n_data, node_size)`` with the sync config's α-β
    override (``node_size`` 1: the degenerate flat topology)."""
    leaves = [(n, tuple(p.shape), p.dtype) for n, p in model.named_leaves()]
    topo = build_topology(n_data, node_size, alpha_beta=tcfg.sync.alpha_beta)
    return GradSync(tcfg.sync, model.sparse_paths, leaves, n_data, group,
                    profiles=sparsity_profiles, topology=topo, pods=pods)


def split_batch(batch: dict, n: int) -> list[dict]:
    """Per-rank batches: contiguous row blocks, or the whole batch on every
    rank when ``n`` does not divide the batch."""
    B = batch["tokens"].shape[0]
    if B % n:
        return [batch] * n
    r = B // n
    return [{k: v[w * r:(w + 1) * r] for k, v in batch.items()}
            for w in range(n)]


def make_train_step(model: Model, tcfg: TrainerConfig, n_data: int,
                    gradsync: GradSync | None = None,
                    state: dict | None = None):
    """Returns ``step_fn(batch) -> metrics`` that updates ``model`` and
    ``step_fn.state`` (the optimizer state) in place.

    ``batch`` holds int tensors tokens/labels [B, S] of the GLOBAL batch on
    the model's device; the group of ``gradsync`` (by default one over
    ``SimGroup(n_data)``) says which ranks this process computes.  Metrics
    are f32 scalars averaged over the group's ranks (``loss``,
    ``grad_norm``, the ``sync/*`` counters and an MoE model's ``moe/*``).  ``state`` continues an
    earlier step function's optimizer state (a replan: bucket keys and
    residual shapes do not depend on schemes)."""
    if tcfg.zero1:
        raise NotImplementedError(
            "ZeRO-1 sharded optimizer state is not ported (ROADMAP queue 1, "
            "item 9); the full update gives the same numbers: zero1=False")
    if tcfg.opt.kind not in UPDATES:
        raise ValueError(f"optimizer kind must be one of {tuple(UPDATES)}, "
                         f"got {tcfg.opt.kind!r}")
    init, update = INITS[tcfg.opt.kind], UPDATES[tcfg.opt.kind]
    if gradsync is None:
        gradsync = make_gradsync(model, tcfg, n_data, SimGroup(n_data))
    group = gradsync.group
    ranks = tuple(group.ranks)
    leaves = model.named_leaves()
    dev = leaves[0][1].device
    if state is None:
        state = {"leaves": {name: init(p) for name, p in leaves}, "step": 0}
        if gradsync.has_compression and gradsync.compress.ef:
            state["residual"] = gradsync.init_residual(dev)
    # this process's per-rank gradients, stacked: [local, ...] per leaf,
    # reused every step
    stacks = {name: torch.empty((len(ranks), *p.shape), dtype=p.dtype,
                                device=p.device) for name, p in leaves}

    def step_fn(batch: dict) -> dict:
        stats: dict[str, list] = {}   # per rank: loss (LM) and moe/*
        per_rank = split_batch(batch, group.n)
        for w, rank in enumerate(ranks):
            b = per_rank[rank]
            model.zero_grad(set_to_none=True)
            loss, m = model.train_loss(b["tokens"], b["labels"])
            loss.backward()
            for k, v in m.items():
                stats.setdefault(k, []).append(v.detach().float())
            for name, p in leaves:
                if p.grad is None:
                    stacks[name][w].zero_()
                else:
                    stacks[name][w].copy_(p.grad)
        model.zero_grad(set_to_none=True)
        if gradsync.has_compression:
            # the residual is donated: updated in place in the state
            synced, res, sync_stats = gradsync(
                stacks, state.get("residual", {}), step=state["step"],
                donate=True)
            if "residual" in state:
                state["residual"] = res
        else:
            synced, sync_stats = gradsync(stacks)
        grads = {name: synced[name][0] for name, _ in leaves}

        metrics = {}
        if tcfg.opt.grad_clip > 0:
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            for name, _ in leaves:
                sq = sq + (grads[name].float() ** 2).sum()
            gn = torch.sqrt(sq)
            scale = torch.clamp(tcfg.opt.grad_clip / (gn + 1e-9), max=1.0)
            grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
            metrics["grad_norm"] = gn
        for name, p in leaves:
            update(tcfg.opt, p, grads[name], state["leaves"][name],
                   state["step"])
        state["step"] += 1
        metrics.update(group.mean({**{k: torch.stack(v)
                                      for k, v in stats.items()},
                                   **sync_stats}))
        return metrics

    step_fn.gradsync = gradsync
    step_fn.state = state
    return step_fn


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(model: Model):
    """``prefill_fn(batch) -> (last-position logits, cache)`` for a batch
    holding ``tokens`` [B, S] on the model's device (inference mode)."""
    def prefill_fn(batch: dict):
        return model.prefill(batch["tokens"])
    return prefill_fn


def make_decode_step(model: Model, window: int = 0, *,
                     return_gap: bool = False):
    """``decode_fn(cache, tokens [B, 1]) -> (next [B, 1], max logit [B],
    cache)`` (plus the top-2 logit gap [B] with ``return_gap``); the cache
    is updated in place (inference mode)."""
    def decode_fn(cache: dict, tokens: torch.Tensor):
        return model.decode(cache, tokens, window=window,
                            return_gap=return_gap)
    return decode_fn
