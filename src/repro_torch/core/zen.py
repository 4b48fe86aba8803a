"""Gradient-synchronization API (port of ``repro.core.zen``).

``GradSync`` maps the per-worker gradients of a model (one ``[local, ...]``
stack per leaf: all workers on the in-process ``SimGroup``, this process's
one rank on a ``DistGroup``) to their mean over the data-parallel group.
Leaves named in ``sparse_paths`` (the row-sparse input embedding
``embed/table``) go through the configured sparse scheme; every other leaf
is a psum.  The leaves are partitioned into buckets (``core/buckets.py``:
dense leaves fused up to ``bucket_bytes``, one bucket per leaf without it)
and synced in the reference's double-buffered pipeline
(``train/schedule.py``): on CUDA every bucket's encode runs on a side
stream GradSync keeps, beside the previous bucket's commit.

The data-parallel world may be two-level (``topology``, built from
``--node-size``; paper §4.1: NVLink inside a node, the network across
nodes): every bucket resolves to a ``CommPlan`` such as
``hier(zen@intra,agsparse@inter)`` whose stages run fastest level first,
over one group per level (``schemes.level_sync``), with capacities grown
across the intra-merge boundary (``schemes.level_budget``); stage 0 runs in
the schedule's ``intra`` slot.  A ``pods`` axis (a ``PxDx1`` mesh) takes
the mean over the pods after the data-parallel sync.  The flat topology
without pods is the single-group path, bit for bit.

With ``compress`` set (``core/sparsify.py``), every dense bucket's payload
is EF-sparsified in its encode's pipeline slot before the scheme sees it:
under ``zen`` it is an element-sparse payload of the bucket's size, whose
layout is sized at ``min(1, 4 density)``.  The EF residual (one f32
``[local, S]`` tensor per compressed bucket) is the caller's state,
threaded through ``gs(grads, residual, step=t)``.

``scheme`` is any executable scheme of the registry
(``registry.cli_scheme_choices()``) or ``auto``, the per-tensor choice:
each row-sparse leaf and each compressed bucket consults its
``SparsityProfile`` (measured, via ``profiles``, or the worst case of its
budget) through ``costmodel.choose_scheme``, on the int world size over a
flat topology and on the α-β topology over a two-level one.  Zen buckets
run their encode in the pipeline's encode slot, every other scheme runs
through ``schemes.stage_sync``.  ``calib_file`` names a measured-cost
table (``costmodel.CalibrationTable``, DESIGN.md §11), loaded once at
plan time: every ``auto`` decision then pays the measured encode and
commit overhead (``GradSync.calib``).
"""
from __future__ import annotations

import collections.abc
import dataclasses
from typing import Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import buckets as bk
from repro_torch.core import costmodel, schemes, sparsify
from repro_torch.core import topology as tpg
from repro_torch.core.hashing import check_backend
from repro_torch.core.registry import StageArgs
from repro_torch.core.schemes import (DistGroup, Held, SimGroup, SyncStats,
                                      level_sync, make_zen_layout,
                                      world_sizes, zero_stats)
from repro_torch.core.topology import CommPlan, Topology, resolve_plan
from repro_torch.optim.optimizers import ef_residual_init
from repro_torch.train import schedule


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How gradients are synchronized across the data-parallel group; the
    reference's fields."""

    scheme: str = "zen"           # a registry scheme (cli_scheme_choices()) | auto
    density_budget: float = 0.25  # capacity sizing for sparse buffers
    k: int = 3                    # Alg. 1 rehash rounds
    r1_factor: float = 2.0        # r1 = r1_factor * nnz_budget / n
    r2_ratio: float = 0.1         # r2 = r2_ratio * r1
    use_hash_bitmap: bool = True  # Alg. 2 on Pull (Fig. 18 ablation knob)
    seed: int = 0                 # hash seeds: schemes.default_seeds(seed)
    # 'auto': per-leaf offline choice; Zen wins iff its volume under the
    # (measured or budget) profile beats dense ring allreduce by this
    # factor (costmodel.choose_scheme), else the leaf falls back to dense
    auto_threshold: float = 1.0
    # Route of Zen's encode / commit / pull stages: "cuda" runs the CUDA
    # kernels (their plain versions for CPU tensors), "torch" the plain
    # versions everywhere.  "cuda" is the counterpart of the reference's
    # "pallas" route; "torch" of its "xla" route.
    backend: str = "cuda"
    # the fused encode / commit megakernels, or the pre-fusion chain of
    # smaller kernels; the same bits either way
    fused_encode: bool = True
    fused_commit: bool = True
    calib_file: str | None = None
    bucket_bytes: int | None = None
    # α-β link override of the topology cost model ('a_intra,b_intra,
    # a_inter,b_inter' in µs and µs/word, or 'a,b'): read where the trainer
    # builds its topology (train/steps.make_gradsync), not here
    alpha_beta: str | None = None
    compress: str = "none"


class GradSync:
    """Synchronize stacked per-worker gradients over the data-parallel
    group (and the pods).

    Args:
      cfg: SyncConfig.
      sparse_paths: path substrings marking row-sparse 2-D leaves.
      leaves: ``[(name, per-worker shape, dtype), ...]`` in gradient
          order; the Zen layouts and the bucket plan are built from them
          offline.
      n_data: size of the data-parallel group.
      group: the collectives' group over the whole world (``pods *
          n_data`` ranks, pod-major): by default ``SimGroup`` of them all
          in this process; a ``DistGroup`` runs this process's rank over
          ``torch.distributed``.
      profiles: optional ``{leaf name or bucket key: SparsityProfile}`` of
          measured sparsity (``costmodel.profile_from_masks``,
          ``DensityController.profiles()``).  Under ``auto`` a profiled
          leaf or bucket is decided from its own curves instead of the
          worst case of its budget.
      topology: the data-parallel world's ``Topology`` (default the
          degenerate flat one over ``n_data``); two-level topologies run
          each bucket's ``CommPlan`` level by level.
      pods: the pod count of a ``PxDx1`` mesh: each pod syncs its
          ``n_data`` ranks, then the pods' results are averaged (the
          reference's ``pmean`` over ``pod``).
    """

    def __init__(self, cfg: SyncConfig, sparse_paths: Sequence[str],
                 leaves: Sequence[tuple[str, tuple, torch.dtype]],
                 n_data: int,
                 group: SimGroup | DistGroup | None = None,
                 profiles: dict | None = None,
                 topology: Topology | None = None, pods: int = 1):
        check_backend(cfg.backend)
        if group is not None and group.n != n_data * pods:
            raise ValueError(f"GradSync: {pods} pod(s) of n_data {n_data} "
                             f"!= the group's size {group.n}")
        self.cfg = cfg
        self.n_data = n_data
        self.pods = pods
        self.group = group or SimGroup(n_data * pods)
        self.sparse_paths = tuple(sparse_paths)
        self.compress = sparsify.parse_compress(cfg.compress)
        # the encodes' side stream, one per CUDA device (train/schedule.py)
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        # the degenerate flat topology (α=0, β=1: time == volume) unless
        # the caller gives one
        self.topology = (topology if topology is not None
                         else tpg.flat_topology(n_data))
        topo = self.topology
        if topo.n != n_data:
            raise ValueError(f"topology covers {topo.n} workers "
                             f"({topo.describe()}) but n_data={n_data}")
        # the world's mixed-radix layout, pod-major (schemes.level_rows)
        self._sizes = world_sizes(topo, pods)
        profiles = profiles or {}
        # measured-time calibration (DESIGN.md §11): loaded once at plan
        # time; every 'auto' decision below then prices encode overhead
        self.calib = (costmodel.CalibrationTable.load(cfg.calib_file)
                      if cfg.calib_file else None)

        def choose(prof) -> str:
            # what 'auto' prices: the int world size on a flat topology
            # (the historical picks), the α-β topology on a two-level one
            return costmodel.choose_scheme(
                prof, max(n_data, 2) if topo.flat else topo,
                threshold=cfg.auto_threshold, calib=self.calib)

        def resolve_scheme(name: str, shape: tuple) -> str:
            """Plan tag of one row-sparse leaf; 'auto' consults the leaf's
            own profile."""
            if len(shape) > 2:
                raise ValueError(f"sparse leaf {name} must be 2-D, got {shape}")
            if cfg.scheme != "auto":
                return cfg.scheme
            prof = profiles.get(name)
            if prof is None:
                rows = shape[0] if len(shape) >= 1 else 1
                d = shape[1] if len(shape) > 1 else 1
                prof = costmodel.worst_case_profile(
                    rows, cfg.density_budget, vw=max(d, 1))
            return choose(prof)

        def resolve_compressed(key: str, size: int) -> str:
            """Plan tag of one EF-compressed dense bucket: 'auto' decides
            from the measured profile when there is one (the
            DensityController's loop), else from the keep-density's worst
            case."""
            if cfg.scheme != "auto":
                return cfg.scheme
            prof = profiles.get(key)
            if prof is None:
                prof = sparsify.compress_profile(self.compress, size)
            return choose(prof)

        self.names = [name for name, _, _ in leaves]
        self.plan = bk.make_bucket_plan(
            leaves, self._is_sparse, cfg.bucket_bytes, resolve_scheme,
            compress=self.compress.tag(),
            compressed_scheme=resolve_compressed)
        self._plans: dict[int, CommPlan] = {
            b.bid: resolve_plan(b.scheme, topo) for b in self.plan.buckets}
        # Zen layouts per (bucket key, level): a row-sparse leaf's rows at
        # the density budget, a compressed dense bucket's elements at the
        # compressed budget, each grown for the level (level_budget);
        # stages of one size share one layout (and its device tables)
        self._layouts: dict[tuple[str, int], schemes.ZenLayout] = {}
        shared: dict[tuple[int, int, float], schemes.ZenLayout] = {}
        for b in self.plan.buckets:
            if b.kind == bk.SPARSE:
                rows, budget = b.slots[0].shape[0], cfg.density_budget
            elif b.compress != "none":
                rows, budget = b.size, self._compressed_budget()
            else:
                continue
            for stage in self._plans[b.bid].stages:
                size = topo.levels[stage.level].size
                if stage.scheme != "zen" or size <= 1:
                    continue
                lb = schemes.level_budget(topo, budget, stage.level)
                if (rows, size, lb) not in shared:
                    shared[rows, size, lb] = make_zen_layout(
                        rows, size, density_budget=lb, key=cfg.seed,
                        k=cfg.k, r1_factor=cfg.r1_factor,
                        r2_ratio=cfg.r2_ratio)
                self._layouts[b.key, stage.level] = shared[rows, size, lb]

    def _is_sparse(self, name: str) -> bool:
        return any(s in name for s in self.sparse_paths)

    def _compressed_budget(self) -> float:
        """Capacity budget of a compressed bucket: 4x the keep-density
        (headroom for EF bursts and threshold drift; the overflow counters
        surface real violations)."""
        return min(1.0, 4 * self.compress.density)

    def describe(self) -> list[str]:
        """One line per bucket, the reference's: kind, bytes, the resolved
        CommPlan over the topology, compressor, key."""
        topo = self.topology
        lines = [f"topology: {topo.describe()}"]
        if self.calib is not None:
            lines.append(
                f"calibration: {len(self.calib.entries)} measured entries "
                f"({self.calib.meta.get('device', '?')}) — 'auto' prices "
                f"encode overhead")
        for b in self.plan.buckets:
            stages = " ; ".join(
                f"{s.scheme}@{topo.levels[s.level].axis}"
                f"[{topo.levels[s.level].size}]"
                for s in self._plans[b.bid].stages)
            comp = "" if b.compress == "none" else f" compress={b.compress}"
            lines.append(f"bucket {b.bid:3d} {b.kind:11s} {b.nbytes:>10d}B "
                         f"plan=[{stages}]{comp}  {b.key}")
        return lines

    def _stage_args(self, bucket: bk.Bucket, scheme: str,
                    level: int) -> StageArgs:
        """Typed StageArgs of one plan stage of a bucket, sized by
        ``schemes.stage_args_for`` from the bucket's budget grown for the
        level (``schemes.level_budget``)."""
        cfg = self.cfg
        budget = (self._compressed_budget() if bucket.compress != "none"
                  else cfg.density_budget)
        rows = (bucket.slots[0].shape[0] if bucket.kind == bk.SPARSE
                else bucket.size)
        return schemes.stage_args_for(
            scheme, rows=rows,
            budget=schemes.level_budget(self.topology, budget, level),
            layout=self._layouts.get((bucket.key, level)),
            use_hash_bitmap=cfg.use_hash_bitmap, backend=cfg.backend,
            fused=cfg.fused_encode, fused_commit=cfg.fused_commit)

    # -- error-feedback residual state ---------------------------------------

    @property
    def has_compression(self) -> bool:
        return self.compress.enabled

    def compressed_buckets(self) -> dict[str, int]:
        """{bucket key: payload element count} of every compressed bucket:
        the residual state's shape contract."""
        return {b.key: b.size for b in self.plan.buckets
                if b.compress != "none"}

    def bucket_schemes(self) -> dict[str, str]:
        """{bucket key: scheme} of the compressed buckets."""
        return {b.key: b.scheme for b in self.plan.buckets
                if b.compress != "none"}

    def init_residual(self, device=None) -> dict[str, torch.Tensor]:
        """Zero EF residual memory: f32 ``[local, S]`` per compressed
        bucket on ``device`` (``cuda`` unless the caller asks for the
        CPU), for the ranks of this process; empty when EF is off."""
        if not (self.compress.enabled and self.compress.ef):
            return {}
        local = len(self.group.ranks)
        return ef_residual_init(
            {k: (local, s) for k, s in self.compressed_buckets().items()},
            resolve_device(device))

    def compress_payload(self, bucket: bk.Bucket, payload: torch.Tensor,
                         residual: torch.Tensor | None, step: int = 0,
                         out_residual: torch.Tensor | None = None):
        """EF-compress a compressed bucket's ``[local, S]`` payload, rank by
        rank (``sparsify.compress_bucket``): (sent [local, S] in the
        payload's dtype, new residual [local, S] f32 or None, d(1) f32
        [local]).  The new residual is written into ``out_residual`` when
        given (it may be ``residual`` itself)."""
        ccfg = self.compress
        seed = (sparsify.randk_seed(ccfg.seed, bucket.bid, step)
                if ccfg.kind == "randk" else None)
        sent = torch.empty_like(payload)
        d1 = torch.empty(payload.shape[0], dtype=torch.float32,
                         device=payload.device)
        new = None
        if residual is not None:
            new = (torch.empty_like(residual) if out_residual is None
                   else out_residual)
        for w in range(payload.shape[0]):
            s, r, d = sparsify.compress_bucket(
                ccfg, payload[w], None if residual is None else residual[w],
                seed=seed)
            sent[w] = s
            d1[w] = d
            if new is not None:
                new[w] = r
        return sent, new, d1

    def _encode_bucket(self, bucket: bk.Bucket, payload: torch.Tensor):
        """Local, collective-free stage: a bucket whose first plan stage is
        Zen on a level larger than 1 encodes to (indices, values);
        everything else passes through."""
        if (bucket.key, 0) in self._layouts:
            enc = schemes.zen_encode(
                payload, layout=self._layouts[bucket.key, 0],
                backend=self.cfg.backend, fused=self.cfg.fused_encode)
            return (payload, enc)
        return (payload,)

    def _stage_fn(self, bucket: bk.Bucket, level: int, enc=None):
        """``fn(x, group, rows) -> (out, SyncStats)``: one plan stage of a
        bucket over one group of its level; ``enc`` carries the prefetched
        ZenEncoded of stage 0 (its workers' rows are ``rows``)."""
        scheme = self._plans[bucket.bid].stages[level].scheme
        n = self.topology.levels[level].size

        def fn(x, group, rows):
            if enc is not None:   # stage 0's groups are consecutive rows
                a, b = rows[0], rows[0] + len(rows)
                return schemes.zen_commit(
                    schemes.ZenEncoded(*(t[a:b] for t in enc)), x,
                    group=group,
                    layout=self._layouts[bucket.key, level],
                    use_hash_bitmap=self.cfg.use_hash_bitmap,
                    backend=self.cfg.backend, fused=self.cfg.fused_commit)
            return schemes.stage_sync(
                scheme, x, group=group, n=n,
                stage_args=self._stage_args(bucket, scheme, level))

        return fn

    def _run_stage(self, bucket: bk.Bucket, level: int, held: Held,
                   enc=None) -> tuple[Held, SyncStats]:
        """One plan stage over every group of its level; a size-1 level is
        the identity with zero words."""
        if self.topology.levels[level].size <= 1:
            return held, zero_stats(len(held.rep), held.vals[0].device)
        axis = len(self._sizes) - 1 - level
        return level_sync(held, self.group, self._sizes, axis,
                          self._stage_fn(bucket, level, enc))

    def _intra_bucket(self, bucket: bk.Bucket, enc):
        """Two-level stage 0: aggregate over the fast (intra) level, in the
        schedule's ``intra`` slot.  Returns (intra sums, stage-0 stats)."""
        return self._run_stage(bucket, 0, Held.of(enc[0]),
                               enc[1] if len(enc) > 1 else None)

    def _commit_bucket(self, bucket: bk.Bucket,
                       enc) -> tuple[torch.Tensor, SyncStats]:
        """Collectives + decode-apply, then the mean (every scheme sums).
        On the flat topology without pods: Zen's commit for an encoded
        bucket, the bucket's scheme through ``schemes.stage_sync``
        otherwise, over the one group.  On a two-level topology
        ``_intra_bucket`` already ran stage 0 and ``enc`` is (intra sums,
        stage-0 stats): stage 1 runs on them, and the stats carry
        ``by_level``.  Pods then average their results."""
        n = self.n_data
        if self.topology.flat and self.pods == 1:
            return self._commit_flat(bucket, enc)
        if self.topology.flat:
            out, st = self._run_stage(bucket, 0, Held.of(enc[0]),
                                      enc[1] if len(enc) > 1 else None)
        else:
            mid, st0 = enc
            out, st1 = self._run_stage(bucket, 1, mid)
            st = SyncStats(sent_words=st0.sent_words + st1.sent_words,
                           overflow=st0.overflow + st1.overflow,
                           by_level=(st0.sent_words, st1.sent_words))
        out = out.map(lambda v: v / n)
        if self.pods > 1:   # the reference's pmean over the pod axis
            out, _ = level_sync(out, self.group, self._sizes, 0, self._pmean)
        return out.stack(), st

    def _pmean(self, x: torch.Tensor, group, _rows):
        """The pods' mean: their psum over ``pods`` (no wire words are
        counted for it, as in the reference)."""
        s = group.psum(x)
        s = ((s[0] / self.pods).expand_as(s) if s.stride(0) == 0
             else s / self.pods)
        return s, zero_stats(x.shape[0], x.device)

    def _commit_flat(self, bucket: bk.Bucket, enc):
        """The flat topology's commit over the one group."""
        g, n = enc[0], self.group.n
        if n <= 1:
            return g, zero_stats(g.shape[0], g.device)
        stage = self._stage_fn(bucket, 0, enc[1] if len(enc) > 1 else None)
        out, st = stage(g, self.group, list(range(g.shape[0])))
        if out.stride(0) == 0:   # SimGroup: one psum seen by every worker
            return (out[0] / n).expand_as(out), st
        return out / n, st

    def upload_tables(self, device) -> list[torch.Tensor]:
        """Upload every Zen layout's offline tables to ``device`` (what the
        first sync there would upload; a CUDA device with its index, as
        the payloads name it) and return them."""
        return [t for lo in self._layouts.values()
                for t in lo.tables(device).values()]

    def _side_stream(self, dev: torch.device) -> torch.cuda.Stream | None:
        """The encodes' side stream on a CUDA ``dev`` (made on first use),
        None on the CPU."""
        if dev.type != "cuda":
            return None
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def _payloads(self, grads: dict[str, torch.Tensor]):
        """(leaf stacks in leaf order, bucket payloads): each payload is
        assembled when the schedule reads it, in its encode's slot."""
        flat = [grads[nm] for nm in self.names]
        return flat, _Payloads(self.plan.buckets, flat)

    def _compress_hook(self, residual, step: int, new_res: dict,
                       extra: dict, donate: bool):
        """The schedule's compress stage: compressed buckets' payloads are
        EF-sparsified; their new residuals and d(1) go to ``new_res`` and
        ``extra``."""
        ef = self.compress.ef

        def hook(bucket: bk.Bucket, payload: torch.Tensor):
            if bucket.compress == "none":
                return payload
            r = residual[bucket.key] if ef else None
            sent, r_new, d1 = self.compress_payload(
                bucket, payload, r, step, out_residual=r if donate else None)
            if r_new is not None:
                new_res[bucket.key] = r_new
            extra[sparsify.DENSITY1_KEY.format(key=bucket.key)] = d1
            return sent

        return hook

    def __call__(self, grads: dict[str, torch.Tensor],
                 residual: dict[str, torch.Tensor] | None = None, *,
                 step: int | None = None, donate: bool = False):
        """``{leaf name: [local, ...] per-worker grads}`` -> (the same dict
        of [local, ...] synced means, metric dict of per-worker vectors).

        With compression the EF residual is threaded through:
        ``gs(grads, residual, step=t) -> (synced, new_residual, stats)``
        (``step`` feeds randk's mask stream); passing ``residual`` always
        selects this form.  ``donate=True`` writes the new residual into
        ``residual``'s tensors, as a jit with donated buffers would."""
        if self.compress.enabled and self.compress.ef and residual is None:
            raise ValueError(
                "EF compression keeps residual state: call "
                "gs(grads, residual) with gs.init_residual() (or the "
                "optimizer-state copy); a fresh zero residual every step "
                "would silently disable error feedback")
        new_res: dict = {}
        extra: dict = {}
        hook = (self._compress_hook(residual, 0 if step is None else int(step),
                                    new_res, extra, donate)
                if self.compress.enabled else None)
        flat, payloads = self._payloads(grads)
        stream = self._side_stream(flat[0].device)
        outs, per_bucket = schedule.run_schedule(
            self.plan.buckets, payloads, self._encode_bucket,
            self._commit_bucket, stream=stream, compress=hook,
            intra=None if self.topology.flat else self._intra_bucket)
        if stream is not None:
            # the compress stage's side outputs were made on the side
            # stream; the current stream reads and frees them from here on
            main = torch.cuda.current_stream(stream.device)
            for t in (*new_res.values(), *extra.values()):
                t.record_stream(main)
        for b, out in zip(self.plan.buckets, outs):
            if b.compress != "none":
                # d(n), the post-aggregation density
                extra[sparsify.DENSITYN_KEY.format(key=b.key)] = \
                    sparsify.density(out != 0)
        synced, stats = self._unbucket(flat, outs, per_bucket, extra)
        if residual is None:
            return synced, stats
        return synced, new_res, stats

    def _unbucket(self, flat: list, outs: list, per_bucket: list,
                  extra: dict | None = None):
        """The synced leaf dict and metrics from the buckets' outputs."""
        synced = list(flat)
        for b, out in zip(self.plan.buckets, outs):
            bk.scatter_bucket(b, out, synced)
        return dict(zip(self.names, synced)), bk.reduce_stats(
            self.plan, per_bucket, extra)


class _Payloads(collections.abc.Sequence):
    """The buckets' payloads as a sequence that gathers bucket ``i``'s
    leaves when it is read (``core/buckets.gather_bucket``)."""

    def __init__(self, buckets: Sequence[bk.Bucket], flat: list):
        self.buckets, self.flat = buckets, flat

    def __len__(self) -> int:
        return len(self.buckets)

    def __getitem__(self, i: int) -> torch.Tensor:
        return bk.gather_bucket(self.buckets[i], self.flat)
