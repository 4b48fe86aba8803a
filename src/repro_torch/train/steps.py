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
     parameters: under ZeRO-1 (``TrainerConfig.zero1``, the default, as
     the reference's) each of the ``world = P x D`` ranks (pod-major)
     updates its flat chunk of every leaf and the new values are
     all-gathered back; with ``zero1=False`` every process updates whole
     leaves.

The optimizer state, ``step_fn.state``, is the reference's: ``{"leaves":
{name: moments}, "step": int}`` plus ``"residual"`` (the EF residuals,
``[local, S]`` f32 per compressed bucket, never chunked) when the sync
keeps one; it is updated in place and can be checkpointed as it is.
Under ZeRO-1 a leaf of ``n`` elements has f32 moments ``[local, c]``, c =
``opt_chunk_size(n, world)``: row ``i`` is rank ``ranks[i]``'s chunk
``[r c, (r + 1) c)`` of the flat leaf zero-padded to ``world x c`` (the
rows of the reference's ``[world, c]`` this process holds: all of them on
``SimGroup``, its own one on ``DistGroup``, so a process there keeps
1 / world of the moments).  Otherwise the moments have the leaf's shape.

``loss`` and the ``sync/*`` metrics are means over the whole group, the
same on every rank.  ``loss`` is the LM loss (``Model.train_loss``'s
``metrics["loss"]``); an MoE model differentiates it plus its weighted
load-balance loss, and its ``moe/*`` stats (each a mean over the layers)
join the metrics as group means too, as the reference's step merges
``train_loss``'s metrics.

ZeRO-1 is a layout of the same elementwise update: its parameters and
moments are bitwise those of the full update.  Each chunk is gathered
after its cast to the parameter's dtype (elementwise, so the bits of the
reference's f32 gather followed by its cast, at half the bytes for bf16).

Under tensor parallelism (``model.ctx.tp`` = M > 1, one process a rank,
``group`` the ranks that share this rank's model index) the step is the
reference's on this rank's shards.  The batch rows go by data index, the
same rows on every model rank.  The gradients of the model-replicated
leaves come out of backward already complete on every model rank: the
layers' ``copy_tp`` sums each one's partial gradients over the model
group, Megatron's placement (``models/common.py``).  So the step
computes the true gradient, equal to the 1x1 run's, where the
reference's psum of those leaves gives M times it (ROADMAP queue 3).
GradSync and ZeRO-1 run over ``group`` on the local shapes (Zen on this
rank's ``[Vp/M, d]`` shard of ``embed/table``); the global-norm clip
counts each sharded leaf's squares over the model group and each
replicated leaf once; the metrics are means over the whole mesh (the
data group's, then the model group's).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.schemes import DistGroup, SimGroup
from repro_torch.core.topology import build_topology
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import INITS, UPDATES, OptConfig


# batch entries beside tokens/labels: whisper's frames, pixtral's patches
MODEL_INPUTS = ("frames", "patches")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    opt: OptConfig = OptConfig()
    sync: SyncConfig = SyncConfig()
    zero1: bool = True


def opt_chunk_size(local_size: int, world: int) -> int:
    """Elements of each rank's ZeRO-1 chunk of a leaf of ``local_size``."""
    return -(-local_size // world)


def _flat_chunk(t: torch.Tensor, lo: int, size: int) -> torch.Tensor:
    """Elements [lo, lo + size) of ``t`` flattened, as a new f32 tensor,
    zero past the end of ``t``."""
    out = torch.zeros(size, dtype=torch.float32, device=t.device)
    part = t.reshape(-1)[lo:lo + size]
    out[:part.numel()] = part
    return out


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
    the model's device (and whisper's f32 ``frames`` or pixtral's f32
    ``patches``, which each rank's ``train_loss`` takes with its rows); the group of ``gradsync`` (by default one over
    ``SimGroup(n_data)``) says which ranks this process computes.  Metrics
    are f32 scalars averaged over the group's ranks and the model group's
    (``loss``, ``grad_norm``, the ``sync/*`` counters and an MoE model's
    ``moe/*``); ``step_fn.stacks`` holds the per-rank gradient stacks the
    step reuses; ``step_fn.rank_metrics`` keeps the last step's before the
    model group's mean (a model rank's own ``sync/*`` words, the
    reference's per-device values).  ``state`` continues an
    earlier step function's optimizer state (a replan: bucket keys and
    residual shapes do not depend on schemes)."""
    if tcfg.opt.kind not in UPDATES:
        raise ValueError(f"optimizer kind must be one of {tuple(UPDATES)}, "
                         f"got {tcfg.opt.kind!r}")
    init, update = INITS[tcfg.opt.kind], UPDATES[tcfg.opt.kind]
    if gradsync is None:
        gradsync = make_gradsync(model, tcfg, n_data, SimGroup(n_data))
    group = gradsync.group
    ranks = tuple(group.ranks)
    # ZeRO-1: the world's P x D ranks (pod-major); this process's ranks are
    # contiguous on both groups, its chunks rows [r0, r0 + local) of each
    # leaf's [world, c]
    world, r0, local = group.n, ranks[0], len(ranks)
    leaves = model.named_leaves()
    dev = leaves[0][1].device
    ctx = model.ctx
    sharded = ({n for n, d in model.shard_dims().items() if d is not None}
               if ctx.tp > 1 else set())

    def moments_like(p: torch.Tensor) -> torch.Tensor:
        """What a leaf's moments are shaped after: the leaf itself, or under
        ZeRO-1 this process's [local, c] rows of its chunks."""
        if not tcfg.zero1:
            return p
        return torch.empty((local, opt_chunk_size(p.numel(), world)),
                           dtype=torch.float32, device=p.device)

    @torch.no_grad()
    def zero1_update(cfg: OptConfig, p: torch.Tensor, g: torch.Tensor,
                     st: dict, step: int) -> None:
        """This process's ranks update their chunks of leaf ``p`` (moments
        ``st`` [local, c]); the chunks, cast to p's dtype, are gathered over
        the group into p."""
        c = opt_chunk_size(p.numel(), world)
        p_my = _flat_chunk(p, r0 * c, local * c).view(local, c)
        update(cfg, p_my, _flat_chunk(g, r0 * c, local * c).view(local, c),
               st, step)
        full = group.all_gather(p_my.to(p.dtype))              # [world, c]
        p.copy_(full.reshape(-1)[:p.numel()].view(p.shape))

    if state is None:
        state = {"leaves": {name: init(moments_like(p))
                            for name, p in leaves}, "step": 0}
        if gradsync.has_compression and gradsync.compress.ef:
            state["residual"] = gradsync.init_residual(dev)
    # this process's per-rank gradients, stacked: [local, ...] per leaf,
    # reused every step
    stacks = {name: torch.empty((len(ranks), *p.shape), dtype=p.dtype,
                                device=p.device) for name, p in leaves}
    # the last step's metrics before the model group's mean (a dict the
    # step refills: no reference from the step to itself, which would keep
    # the model and the state alive past the program)
    rank_metrics: dict = {}

    def step_fn(batch: dict) -> dict:
        stats: dict[str, list] = {}   # per rank: loss (LM) and moe/*
        per_rank = split_batch(batch, group.n)
        for w, rank in enumerate(ranks):
            b = per_rank[rank]
            model.zero_grad(set_to_none=True)
            loss, m = model.train_loss(
                b["tokens"], b["labels"],
                **{k: b[k] for k in MODEL_INPUTS if k in b})
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
            sq_sharded = torch.zeros_like(sq)
            for name, _ in leaves:
                s2 = (grads[name].float() ** 2).sum()
                if name in sharded:
                    sq_sharded = sq_sharded + s2
                else:
                    sq = sq + s2
            if sharded:
                sq = sq + ctx.psum_tp(sq_sharded)
            gn = torch.sqrt(sq)
            scale = torch.clamp(tcfg.opt.grad_clip / (gn + 1e-9), max=1.0)
            grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
            metrics["grad_norm"] = gn
        apply = zero1_update if tcfg.zero1 else update
        for name, p in leaves:
            apply(tcfg.opt, p, grads[name], state["leaves"][name],
                  state["step"])
        state["step"] += 1
        metrics.update(group.mean({**{k: torch.stack(v)
                                      for k, v in stats.items()},
                                   **sync_stats}))
        rank_metrics.clear()
        rank_metrics.update(metrics)
        return ctx.mean_tp(metrics)

    step_fn.gradsync = gradsync
    step_fn.state = state
    step_fn.stacks = stacks
    step_fn.rank_metrics = rank_metrics
    return step_fn


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(model: Model):
    """``prefill_fn(batch) -> (last-position logits, cache)`` for a batch
    holding ``tokens`` [B, S] (and whisper's ``frames`` or pixtral's
    ``patches``) on the model's device (inference mode)."""
    def prefill_fn(batch: dict):
        return model.prefill(batch["tokens"],
                             **{k: batch[k] for k in MODEL_INPUTS
                                if k in batch})
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
