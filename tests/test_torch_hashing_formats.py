"""Port parity: hashing, compaction, Alg. 1 and bitmaps, bitwise against
the JAX reference (``repro.core.hashing`` / ``repro.core.formats``).

Both packages get the same numpy inputs; the port runs on the CPU.  The
hash seeds are the reference layout's (drawn with JAX's threefry)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import formats as F
from repro.core import hashing as H
from repro.core import schemes as S
from repro_torch.core import formats as TF
from repro_torch.core import hashing as TH
from repro_torch.core import schemes as TS

EMPTY = int(H.EMPTY)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _words(x) -> np.ndarray:
    """Reference uint32 words as the port's int32 bit patterns."""
    return np.asarray(x).astype(np.uint32).view(np.int32)


def _seeds(k: int = 3, key: int = 0) -> list[int]:
    lo = S.make_zen_layout(1024, 4, density_budget=0.1, key=key, k=k)
    return [int(s) for s in lo.seeds]


def test_empty_sentinel_matches():
    assert TH.EMPTY == EMPTY == 2**31 - 1


@pytest.mark.parametrize("seed", [1, 0x9E3779B9, 2**31 - 2, 4_000_000_000])
def test_hash_u32_and_hash_mod_bitwise(seed):
    rng = np.random.default_rng(seed % 1000)
    x = rng.integers(-2**31, 2**31 - 1, size=4096, dtype=np.int64)
    x = np.concatenate([x, [0, -1, EMPTY, -2**31]]).astype(np.int32)
    ref = np.asarray(H.hash_u32(jnp.asarray(x), seed)).astype(np.int64)
    np.testing.assert_array_equal(TH.hash_u32(_t(x), seed).numpy(), ref)
    for m in (1, 7, 8, 9496, 151936):
        np.testing.assert_array_equal(
            TH.hash_mod(_t(x), seed, m).numpy(),
            np.asarray(H.hash_mod(jnp.asarray(x), seed, m)))


def test_fmix32_bitwise():
    x = np.random.default_rng(3).integers(0, 2**32, size=2048, dtype=np.uint64)
    ref = np.asarray(H.fmix32(jnp.asarray(x.astype(np.uint32))))
    got = TH.fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("M,cap,density", [(1000, 64, 0.03), (1000, 64, 0.5),
                                           (257, 300, 1.0)])
def test_compact_indices_and_rows_bitwise(M, cap, density):
    rng = np.random.default_rng(M)
    mask = rng.random((3, M)) < density
    r_idx, r_ov = H.compact_rows(jnp.asarray(mask), cap)
    t_idx, t_ov = TH.compact_rows(_t(mask), cap)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(t_ov.numpy(), np.asarray(r_ov))
    r1, o1 = H.compact_indices(jnp.asarray(mask[0]), cap)
    t1, q1 = TH.compact_indices(_t(mask[0]), cap)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(r1))
    assert int(q1) == int(o1)


def test_partition_rank_bitwise():
    rng = np.random.default_rng(5)
    p = rng.integers(0, 6, size=500).astype(np.int32)
    surv = rng.random(500) < 0.4
    ref = np.asarray(H.partition_rank(jnp.asarray(p), jnp.asarray(surv), 6))
    np.testing.assert_array_equal(
        TH.partition_rank(_t(p), _t(surv), 6).numpy(), ref)


@pytest.mark.parametrize("M,n,r1,r2,density", [
    (4096, 4, 512, 64, 0.05),
    (4096, 8, 128, 16, 0.2),
    (4096, 4, 64, 4, 0.3),          # serial memory overflows
])
def test_hierarchical_hash_and_row_compact_bitwise(M, n, r1, r2, density):
    rng = np.random.default_rng(M + n)
    mask = rng.random(M) < density
    cap = int(M * density * 1.5) + 32
    idx = np.asarray(H.compact_indices(jnp.asarray(mask), cap)[0])
    seeds = _seeds()
    ref = H.hierarchical_hash(jnp.asarray(idx), n=n, r1=r1, r2=r2, k=3,
                              seeds=jnp.asarray(seeds, jnp.uint32))
    got = TH.hierarchical_hash(_t(idx), n=n, r1=r1, r2=r2, k=3, seeds=seeds)
    np.testing.assert_array_equal(got.memory.numpy(), np.asarray(ref.memory))
    assert int(got.overflow) == int(ref.overflow)
    np.testing.assert_array_equal(got.rounds_used.numpy(),
                                  np.asarray(ref.rounds_used))
    if r2 == 4:
        assert int(ref.overflow) > 0, "edge case no longer overflows"
    np.testing.assert_array_equal(TH.row_compact(got.memory).numpy(),
                                  np.asarray(H.row_compact(ref.memory)))


@pytest.mark.parametrize("length", [1, 31, 32, 33, 1000])
def test_bitmap_encode_decode_bitwise(length):
    rng = np.random.default_rng(length)
    mask = rng.random((3, length)) < 0.4
    ref_words = np.stack([np.asarray(F.bitmap_encode(jnp.asarray(m)))
                          for m in mask])
    got_words = TF.pack_rows(_t(mask)).numpy()
    np.testing.assert_array_equal(got_words, _words(ref_words))
    np.testing.assert_array_equal(TF.bitmap_encode(_t(mask[0])).numpy(),
                                  _words(ref_words[0]))
    np.testing.assert_array_equal(
        TF.bitmap_decode_batch(_t(_words(ref_words)), length).numpy(),
        np.asarray(F.bitmap_decode_batch(jnp.asarray(ref_words), length)))
    for cap in (1, 7, length):
        np.testing.assert_array_equal(
            TF.bitmap_decode_compact(_t(_words(ref_words)), length,
                                     cap).numpy(),
            np.asarray(F.bitmap_decode_compact(jnp.asarray(ref_words),
                                               length, cap)))


@pytest.mark.parametrize("M,n,budget", [(4096, 4, 0.1), (3000, 8, 0.25),
                                        (151936 // 32, 8, 0.25)])
def test_zen_layout_bitwise_with_reference_seeds(M, n, budget):
    ref = S.make_zen_layout(M, n, density_budget=budget, key=3)
    got = TS.make_zen_layout(M, n, density_budget=budget, seeds=ref.seeds)
    for f in ("perm", "offsets", "local_pos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    for f in ("cap_server", "cap_index", "r1", "r2", "k",
              "cap_bitmap_words"):
        assert getattr(got, f) == getattr(ref, f), f


def test_default_seeds_are_the_ports_own():
    """The port's default seeds come from numpy, not threefry: same shape
    and range as the reference's, different values (so callers that need
    the reference's partitions must pass its seeds)."""
    s = TS.default_seeds(0, 3)
    assert s.dtype == np.uint32 and s.shape == (4,)
    assert ((s >= 1) & (s < 2**31 - 1)).all()
    assert list(s) != _seeds(key=0)
    np.testing.assert_array_equal(TS.default_seeds(0, 3), s)


@pytest.mark.parametrize("length", [1, 4099, 300_017])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_layout_partition_pass_equals_stable_argsort(length, n):
    """The layout's per-partition pass gives the stable argsort of the
    partition ids: perm, offsets, local_pos and cap_server."""
    lo = TS.make_zen_layout(length, n, density_budget=0.04, key=7)
    p = TH.hash_mod(torch.arange(length, dtype=torch.int32),
                    int(lo.seeds[0]), n).numpy()
    order = np.argsort(p, kind="stable").astype(np.int32)
    counts = np.bincount(p, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    local = np.empty(length, dtype=np.int32)
    local[order] = np.arange(length, dtype=np.int32) - offsets[p[order]]
    for name, want in (("perm", order), ("offsets", offsets),
                       ("local_pos", local)):
        got = getattr(lo, name)
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert lo.cap_server == int(counts.max())


# ---------------------------------------------------------------------------
# COO, tensor blocks, the hash bitmap and the strawman hash
# ---------------------------------------------------------------------------

def _sparse_dense(shape, density, seed):
    rng = np.random.default_rng(seed)
    keep = rng.random(shape[0]) < density
    x = rng.standard_normal(shape).astype(np.float32)
    return x * keep.reshape(-1, *([1] * (len(shape) - 1)))


@pytest.mark.parametrize("shape", [(256,), (256, 3)], ids=["element", "row"])
@pytest.mark.parametrize("cap", [8, 64, 300])
def test_coo_encode_decode_bitwise(shape, cap):
    x = _sparse_dense(shape, 0.2, cap)
    ref = F.coo_encode(jnp.asarray(x), cap)
    got = TF.coo_encode(_t(x), cap)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert got.capacity == ref.capacity
    assert int(got.nnz()) == int(ref.nnz())
    assert int(got.wire_bytes()) == int(ref.wire_bytes())
    np.testing.assert_array_equal(np.asarray(F.coo_decode(ref, 256)),
                                  TF.coo_decode(got, 256).numpy())


@pytest.mark.parametrize("shape", [(256,), (256, 3)], ids=["element", "row"])
@pytest.mark.parametrize("block,cap", [(8, 3), (8, 40), (4, 64)])
def test_blocks_encode_decode_bitwise(shape, block, cap):
    x = _sparse_dense(shape, 0.05, block + cap)
    ref = F.blocks_encode(jnp.asarray(x), block, cap)
    got = TF.blocks_encode(_t(x), block, cap)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(got.n_blocks()) == int(ref.n_blocks())
    assert int(got.wire_bytes()) == int(ref.wire_bytes())
    np.testing.assert_array_equal(np.asarray(F.blocks_decode(ref, 256)),
                                  TF.blocks_decode(got, 256).numpy())
    with pytest.raises(ValueError, match="multiple of block"):
        TF.blocks_encode(_t(x[:250]), block, cap)


@pytest.mark.parametrize("n", [1, 4, 7])
def test_hash_bitmap_layout_encode_decode_bitwise(n):
    seeds = H.make_seeds(0, 4)
    ref = F.make_hash_bitmap_layout(1000, n, seeds)
    got = TF.make_hash_bitmap_layout(1000, n, np.asarray(seeds))
    assert got.n == ref.n == n
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = _sparse_dense((1000, 2), 0.1, n)
    w = F.hash_bitmap_encode(jnp.asarray(x), ref)
    tw = TF.hash_bitmap_encode(_t(x), got)
    np.testing.assert_array_equal(_words(w), tw.numpy())
    np.testing.assert_array_equal(np.asarray(F.hash_bitmap_decode(w, ref)),
                                  TF.hash_bitmap_decode(tw, got).numpy())
    for m in (1, 31, 32, 33, 1000):
        assert TF.bitmap_wire_bytes(m) == F.bitmap_wire_bytes(m)
        assert TF.hash_bitmap_wire_bytes(m) == F.hash_bitmap_wire_bytes(m)


@pytest.mark.parametrize("n,r", [(4, 8), (2, 64), (1, 3)])
def test_strawman_hash_bitwise(n, r):
    rng = np.random.default_rng(n * r)
    idx = np.full(64, EMPTY, np.int32)
    idx[:40] = rng.choice(5000, 40, replace=False)
    for seed in (0, 12345, _seeds()[1]):
        mem, lost = H.strawman_hash(jnp.asarray(idx), n=n, r=r, seed=seed)
        tmem, tlost = TH.strawman_hash(_t(idx), n=n, r=r, seed=seed)
        np.testing.assert_array_equal(np.asarray(mem), tmem.numpy())
        assert int(lost) == int(tlost)
