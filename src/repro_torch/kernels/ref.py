"""Plain PyTorch versions of the port's CUDA kernels.

Port of ``repro.kernels.ref``.  Each function here is the plain version of
one hand-written kernel in ``csrc/``: the CPU tests hold it against the JAX
reference, and ``chip_smoke.py`` holds the kernel against it on the card.
They run on any device; ``kernels/ops.py`` takes them for CPU tensors.
Bitmap words are int32 tensors carrying the reference's uint32 bits.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.formats import (BITS, bitmap_decode_batch,
                                      bitmap_decode_compact, bitmap_encode,
                                      pack_rows)
from repro_torch.core.hashing import (EMPTY, compact_indices, hash_u32,
                                      hierarchical_hash)
# the cumsum + scatter compaction IS the plain route's extraction, so the
# kernel's plain version is an alias, as in the reference
from repro_torch.core.hashing import row_compact as row_compact_ref  # noqa: F401


def hash_stage_ref(indices: torch.Tensor, seeds: Sequence[int], n: int,
                   r1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The hash stage of Alg. 1: p = h0(idx) mod n and q_i = h_i(idx) mod
    r1 for the k seeds after the first.  indices int32 [C] (EMPTY-padded)
    -> (p int32 [C], q int32 [k, C]); EMPTY maps to the (n, r1) sentinels."""
    valid = indices != EMPTY
    seeds = [int(s) for s in seeds]
    p = (hash_u32(indices, seeds[0]) % n).to(torch.int32)
    qs = [torch.where(valid, (hash_u32(indices, s) % r1).to(torch.int32), r1)
          for s in seeds[1:]]
    return torch.where(valid, p, n), torch.stack(qs)


def bitmap_pack_ref(bits: torch.Tensor) -> torch.Tensor:
    """0/1 [W*32] -> int32 [W] packed words (LSB first)."""
    return pack_rows(bits.reshape(-1, BITS) != 0)[:, 0]


def bitmap_unpack_ref(words: torch.Tensor) -> torch.Tensor:
    """int32 [W] words -> int32 0/1 [W*32]."""
    w = words.to(torch.int64)[:, None] & 0xFFFFFFFF
    shift = torch.arange(BITS, dtype=torch.int64, device=words.device)
    return ((w >> shift) & 1).reshape(-1).to(torch.int32)


def bitmap_pack_rows_ref(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the pack kernel: bool/0-1 [n, L] -> int32 words
    [n, ceil(L/32)], each row LSB first, bits past L zero."""
    return pack_rows(mask != 0)


def bitmap_unpack_rows_ref(words: torch.Tensor, length: int) -> torch.Tensor:
    """Plain version of the unpack kernel: int32 words [n, W] -> bool
    [n, length] (length <= 32 W), contiguous."""
    return bitmap_decode_batch(words, length).contiguous()


def coo_scatter_add_ref(out: int | torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """``out[idx[i]] += vals[i]``, returned as a new tensor; an int ``out``
    means zeros of that many rows.  EMPTY, negative and out-of-range rows
    are dropped (the reference's kernel drops negatives; its XLA route,
    which no caller feeds one, wraps them).  Duplicates accumulate in
    stream order, in the values' dtype, starting from ``out``'s row (one
    rounding per add, as the reference's scatter-add).

    Stream order per target is kept by adding occurrence by occurrence: pass
    ``j`` adds every row that is the ``j``-th occurrence of its target, so
    targets are unique within a pass and ``index_add_`` is exact whatever
    its internal order.  Each pass adds with ``index_put_`` of
    ``out[t] + v``: one rounding per add, as ``index_add_`` would, but it
    writes the targets only (CUDA's bf16 ``index_add_`` at odd d adds
    through 32-bit words, adding +0.0 to the row beside a target and so
    turning an untouched -0.0 into +0.0)."""
    if isinstance(out, int):
        out = torch.zeros((out, vals.shape[-1]), dtype=vals.dtype,
                          device=vals.device)
    else:
        out = out.clone()
    rows, C = out.shape[0], idx.shape[0]
    live = (idx >= 0) & (idx < rows)
    tgt = torch.where(live, idx.to(torch.int64), rows)
    order = torch.argsort(tgt, stable=True)
    srt = tgt[order]
    pos = torch.arange(C, device=idx.device)
    start = torch.ones(C, dtype=torch.bool, device=idx.device)
    start[1:] = srt[1:] != srt[:-1]
    run_start = torch.cummax(torch.where(start, pos, 0), dim=0).values
    occ = torch.empty_like(pos)
    occ[order] = pos - run_start
    occ = torch.where(live, occ, -1)
    for j in range(int(occ.max().item()) + 1 if C else 0):
        sel = occ == j
        t = tgt[sel]
        out.index_put_((t,), out[t] + vals[sel])
    return out


def zen_encode_ref(indices: torch.Tensor, seeds: Sequence[int], n: int,
                   r1: int, r2: int):
    """Plain version of the encode kernel: Alg. 1 + row compaction + the
    prefix occupancy bitmap.  indices int32 [C] (unique, EMPTY-padded) ->
    (pidx int32 [n, r1+r2], occ int32 words [n, ceil((r1+r2)/32)],
    overflow int32 scalar)."""
    part = hierarchical_hash(indices, n=n, r1=r1, r2=r2, k=len(seeds) - 1,
                             seeds=seeds)
    pidx = row_compact_ref(part.memory)
    return pidx, pack_rows(pidx != EMPTY), part.overflow


def zen_commit_push_ref(lp: torch.Tensor, vals: torch.Tensor,
                        cap_server: int, cap_pull: int):
    """Plain version of the commit push kernel: aggregation into
    [cap_server, d], mask ``any(row != 0)``, ascending compaction to
    ``cap_pull``, value gather and the LSB-first server bitmap.
    lp int32 [C], vals [C(, d)] -> (lpos int32 [cap_pull], vals
    [cap_pull(, d)], bm int32 words [ceil(cap_server/32)], overflow)."""
    squeeze = vals.ndim == 1
    v2 = vals[:, None] if squeeze else vals
    buf = coo_scatter_add_ref(cap_server, lp, v2)
    mask = (buf != 0).any(dim=-1)
    lpos, overflow = compact_indices(mask, cap_pull)
    dead = lpos == EMPTY
    out = buf[torch.where(dead, 0, lpos).to(torch.int64)]
    out = torch.where(dead[:, None], torch.zeros_like(out), out)
    return lpos, (out[:, 0] if squeeze else out), bitmap_encode(mask), overflow


def zen_commit_pull_ref(words: torch.Tensor, cap_server: int,
                        cap_pull: int) -> torch.Tensor:
    """Plain version of the pull kernel: each row's set bits below
    ``cap_server``, ascending, first ``cap_pull``, EMPTY-padded.
    words int32 [n, W] -> int32 [n, cap_pull]."""
    return bitmap_decode_compact(words, cap_server, cap_pull)


NEG = -1e30   # the reference's mask value (``layers.NEG``)


def _flash_valid(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
                 window: int) -> torch.Tensor:
    """[Tq, Tk] bool: the keys each query row keeps."""
    valid = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool,
                       device=pos_q.device)
    if causal:
        valid &= pos_k[None, :] <= pos_q[:, None]
    if window > 0:
        valid &= pos_k[None, :] > pos_q[:, None] - window
    return valid


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  chunk: int = 512, q_chunk: int = 1024,
                  return_lse: bool = False):
    """GQA attention by online softmax over KV chunks (the reference's
    ``layers._flash_inner`` / ``flash_attention``), in float64: the
    kernels' yardstick and the CPU route round the exact result once to
    q's dtype (the reference's f32 sums and exps part from it by a few f32
    ulps, the kernels' too).

    q [B, Sq, H, hd]; k [B, Sk, KV, hd]; v [B, Sk, KV, hd_v], H % KV == 0.
    Query row i sits at position ``q_offset + i``; key j at j.  ``causal``
    keeps keys j <= position, ``window > 0`` keys j > position - window.
    Returns [B, Sq, H, hd_v] in q's dtype; with ``return_lse`` also the
    rows' log-sum-exp of the scaled scores, ``m + log l``, [B, Sq, H] f32
    (+inf for a row that keeps no key: ``flash_bwd_ref`` gives it zero
    gradient)."""
    B, Sq, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    g = H // KV
    f64 = torch.float64
    qf = (q.to(f64) * (1.0 / math.sqrt(hd))).reshape(B, Sq, KV, g, hd)
    kf, vf = k.to(f64), v.to(f64)
    out = torch.empty((B, Sq, KV, g, hd_v), dtype=f64, device=q.device)
    lse = torch.empty((B, Sq, KV, g), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, q_chunk):
        qb = qf[:, q0:q0 + q_chunk]
        Tq = qb.shape[1]
        pos_q = q_offset + q0 + torch.arange(Tq, device=q.device)
        m = torch.full((B, Tq, KV, g), NEG, dtype=f64, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((B, Tq, KV, g, hd_v), dtype=f64, device=q.device)
        for c0 in range(0, Sk, chunk):
            kb, vb = kf[:, c0:c0 + chunk], vf[:, c0:c0 + chunk]
            pos_k = c0 + torch.arange(kb.shape[1], device=q.device)
            s = torch.einsum("bqkgh,bckh->bqkgc", qb, kb)
            valid = _flash_valid(pos_q, pos_k, causal, window)
            s = torch.where(valid[None, :, None, None, :], s, NEG)
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p, vb)
            m = m_new
        out[:, q0:q0 + Tq] = o / l.clamp(min=1e-30)[..., None]
        if return_lse:   # m is NEG only where every key was masked
            lse[:, q0:q0 + Tq] = torch.where(m == NEG, math.inf,
                                             m + torch.log(l))
    out = out.reshape(B, Sq, H, hd_v).to(q.dtype)
    return (out, lse.reshape(B, Sq, H)) if return_lse else out


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  chunk: int = 512, q_chunk: int = 1024):
    """The gradient of :func:`flash_fwd_ref` (the reference differentiates
    its ``flash_attention`` by autodiff through the online softmax; this
    is the same gradient, taken block by block from the forward's row
    log-sum-exp).

    q, k, v, the output o [B, Sq, H, hd_v], lse [B, Sq, H] f32 (the
    forward's ``return_lse``) and the output's gradient do -> (dq, dk, dv)
    in q's, k's and v's dtypes.  In f32, per block of ``q_chunk`` queries
    and ``chunk`` keys: P = exp(s - lse) on the kept keys (s the scaled
    scores), dV += P^T dO, dP = dO V^T, dS = P (dP - D) with D =
    rowsum(dO o), dQ += dS K / sqrt(hd), dK += dS^T Q / sqrt(hd); dk and dv
    sum each KV head's g q heads.  A block that no query of it keeps a key
    of (above the causal diagonal, before the window) is skipped on the
    Python integers of its bounds, never on a device value, so the loop
    makes no host sync.  Each transient is at most B x q_chunk x H x chunk
    f32, the forward's bound.  A row whose lse is +inf (it keeps no key)
    has P = 0: zero gradient."""
    B, Sq, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).reshape(B, Sq, KV, g, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, KV, g, hd_v)
    D = (dof * o.float().reshape(B, Sq, KV, g, hd_v)).sum(-1)
    lse = lse.reshape(B, Sq, KV, g)
    dq = torch.zeros((B, Sq, KV, g, hd), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, Sk, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Sk, KV, hd_v), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, q_chunk):
        Tq = min(q_chunk, Sq - q0)
        first, last = q_offset + q0, q_offset + q0 + Tq - 1
        qb, dob = qf[:, q0:q0 + Tq], dof[:, q0:q0 + Tq]
        lb, Db = lse[:, q0:q0 + Tq, ..., None], D[:, q0:q0 + Tq, ..., None]
        pos_q = first + torch.arange(Tq, device=q.device)
        for c0 in range(0, Sk, chunk):
            Tc = min(chunk, Sk - c0)
            if (causal and c0 > last) \
                    or (window > 0 and c0 + Tc - 1 <= first - window):
                continue
            kb, vb = kf[:, c0:c0 + Tc], vf[:, c0:c0 + Tc]
            pos_k = c0 + torch.arange(Tc, device=q.device)
            valid = _flash_valid(pos_q, pos_k, causal, window)
            s = torch.einsum("bqkgh,bckh->bqkgc", qb, kb)
            p = torch.where(valid[None, :, None, None, :],
                            torch.exp(s - lb), 0.0)
            dv[:, c0:c0 + Tc] += torch.einsum("bqkgc,bqkgh->bckh", p, dob)
            dp = torch.einsum("bqkgh,bckh->bqkgc", dob, vb)
            ds = p * (dp - Db)
            dq[:, q0:q0 + Tq] += torch.einsum("bqkgc,bckh->bqkgh", ds, kb)
            dk[:, c0:c0 + Tc] += torch.einsum("bqkgc,bqkgh->bckh", ds, qb)
    return ((dq * scale).reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def ssd_fwd_ref(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, *, chunk: int = 64):
    """The Mamba2 SSD chunk scan (the reference's ``kernels/ssd.py``
    ``_kernel``, looped over chunks with the state carried across them).

    x [Bt, S, H, hd] f32 with dt folded in; dA [Bt, S, H] f32 log-decays
    (dt * A); Bm, Cm [Bt, S, N] f32, shared by all heads (ngroups = 1).
    S must be a multiple of Q = min(chunk, S).  Per chunk, with
    cs = cumsum(dA), L_ij = exp(cs_i - cs_j) for j <= i (else 0) and
    w = exp(cs_Q - cs):

        y = ((C B^T) o L) x + exp(cs) o (C S^T)
        S <- S exp(cs_Q) + (x o w)^T B

    Returns (y [Bt, S, H, hd] f32, final state [Bt, H, hd, N] f32).  The
    reference kernel's head-major [B*H, S, hd] layout is a transpose of
    this one; B and C are not broadcast per head.  Under autograd L's
    exponent is masked before the exp, so the gradient stays finite when a
    chunk's decay span passes exp's range (the reference's jnp scan, which
    masks after it, gives NaN there); elsewhere the values and gradients
    are those of masking after."""
    Bt, S, H, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_fwd: S={S} is not a multiple of the chunk {Q}")
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((Bt, H, hd, N), dtype=torch.float32, device=x.device)
    y = torch.empty((Bt, S, H, hd), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, Q):
        xq, bq, cq = x[:, c0:c0 + Q], Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        cs = torch.cumsum(dA[:, c0:c0 + Q], dim=1)               # [Bt,Q,H]
        total = cs[:, -1]                                         # [Bt,H]
        # masked before the exp: above the diagonal cs_i - cs_j >= 0 may
        # overflow exp, and where() would then pass 0 * inf = NaN back
        decay = torch.exp(torch.where(tri[None, :, :, None],
                                      cs[:, :, None, :] - cs[:, None, :, :],
                                      float("-inf")))             # [Bt,Qi,Qj,H]
        sbc = torch.einsum("bin,bjn->bij", cq, bq)                # [Bt,Qi,Qj]
        y_in = torch.einsum("bijh,bjhd->bihd", sbc[..., None] * decay, xq)
        y_st = torch.einsum("bin,bhdn->bihd", cq, state) \
            * torch.exp(cs)[..., None]
        y[:, c0:c0 + Q] = y_in + y_st
        w = torch.exp(total[:, None, :] - cs)                     # [Bt,Q,H]
        ds = torch.einsum("bqhd,bqn->bhdn", xq * w[..., None], bq)
        state = state * torch.exp(total)[:, :, None, None] + ds
    return y, state
