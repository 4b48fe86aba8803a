"""Port parity: the double-buffered bucket pipeline (``train/schedule.py``)
against the reference's ``repro.train.schedule``.

* ``run_schedule`` issues encode and commit in the reference's order,
  encode(0), then encode(i+1) before commit(i) (a recording encode and
  commit through both);
* on the CPU it equals ``run_in_order`` (encode then commit, bucket by
  bucket) bit for bit on a bucketed GradSync's zen and dense buckets, on
  the fused route and the unfused chain; ``encode_all`` gives the encodes
  of the pipeline.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.train import schedule as rsched
from repro_torch.core import buckets as bk
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.train import schedule


def _recorder(log: list, lib):
    def encode(b, p):
        log.append(("encode", b))
        return lib.asarray(p)

    def commit(b, enc):
        log.append(("commit", b))
        return enc, None
    return encode, commit


@pytest.mark.parametrize("nb", [0, 1, 2, 5])
def test_issue_order_is_the_references(nb):
    buckets, payloads = list(range(nb)), [float(i) for i in range(nb)]
    ref_log, got_log = [], []
    rsched.run_schedule(buckets, payloads, *_recorder(ref_log, jnp))
    outs, stats = schedule.run_schedule(buckets, payloads,
                                        *_recorder(got_log, torch))
    assert got_log == ref_log
    want = [("encode", 0)] if nb else []
    for i in range(nb):
        want += ([("encode", i + 1)] if i + 1 < nb else []) + [("commit", i)]
    assert got_log == want
    assert [float(o) for o in outs] == payloads and stats == [None] * nb


def _gradsync(scheme, bucket_bytes, **route):
    leaves = [("embed/table", (512, 8), torch.float32),
              ("a/w", (32, 16), torch.bfloat16), ("a/b", (16,), torch.bfloat16),
              ("norm", (16,), torch.float32), ("head/w", (16, 24),
                                               torch.float32)]
    gs = GradSync(SyncConfig(scheme=scheme, bucket_bytes=bucket_bytes,
                             **route), ["embed/table"], leaves, 4)
    rng = np.random.default_rng(5)
    grads = {}
    for name, shape, dt in leaves:
        g = np.round(rng.standard_normal((4, *shape)) * 8) / 8
        if name == "embed/table":
            g *= (rng.random((4, shape[0])) < 0.1)[..., None]
        grads[name] = torch.from_numpy(g.astype(np.float32)).to(dt)
    return gs, grads


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


ROUTES = {"fused": {}, "unfused": dict(fused_encode=False,
                                       fused_commit=False)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("bucket_bytes", [None, 1024, 1 << 20])
@pytest.mark.parametrize("scheme", ["zen", "dense"])
def test_run_schedule_equals_run_in_order(scheme, bucket_bytes, route):
    gs, grads = _gradsync(scheme, bucket_bytes, **ROUTES[route])
    got_out, got_st = gs(grads)
    flat, payloads = gs._payloads(grads)
    outs, per = schedule.run_in_order(gs.plan.buckets, payloads,
                                      gs._encode_bucket, gs._commit_bucket)
    want_out, want_st = gs._unbucket(flat, outs, per)
    assert list(got_out) == list(want_out) == gs.names
    for name in got_out:
        a, b = got_out[name], want_out[name]
        assert a.dtype == b.dtype and a.shape == b.shape == grads[name].shape
        assert torch.equal(_bits(a), _bits(b)), name
    assert sorted(got_st) == sorted(want_st)
    for k in got_st:
        assert torch.equal(got_st[k], want_st[k]), k
    if bucket_bytes == 1 << 20:   # one fused bucket per dtype run
        assert [len(b.slots) for b in gs.plan.buckets] == [1, 2, 2]
    # the pipeline's local prefix alone: the same encodes
    for b, enc, p in zip(gs.plan.buckets,
                         schedule.encode_all(gs.plan.buckets, payloads,
                                             gs._encode_bucket),
                         payloads):
        assert torch.equal(enc[0], p)
        assert (len(enc) == 2) == (b.kind == bk.SPARSE and scheme == "zen")
