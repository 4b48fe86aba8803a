"""Port parity: the paper's baseline schemes (agsparse, sparcml, sparse_ps,
omnireduce, balanced) on the simulated group against the reference's
``schemes.simulate``, and ``stage_sync``'s registry dispatch.

* each scheme at n in {2, 4, 8} (sparcml at powers of two),
  element-sparse [M] and row-sparse [M, d], f32 and bf16, dyadic values
  (every sum exact) and random normal values (sums rounded, so the order
  of the adds shows): outputs, ``sent_words`` and overflow bitwise, on
  both routes (``backend="cuda"`` takes the scatter-add's plain version
  for CPU tensors, which it counts);
* a skewed (Zipf) stream that overflows small capacities, and capacities
  past M (balanced's ``n * cap_push`` local budget above M);
* ``stage_sync`` with ``stage_args_for``'s provisioning equals the direct
  call; its config-named errors are the reference's
  (tests/test_balanced.py's registry cases), and the divisibility errors
  carry the reference's text; ``costmodel._feasible`` agrees with them.

Inputs are the reference's ``metrics.synth_sparse_masks`` (Zipf
positions) times ``jax.random.normal`` values, made here once per case.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import metrics
from repro.core import schemes as S
from repro.core.registry import StageArgs as RefStageArgs
from repro_torch.core import costmodel as TC
from repro_torch.core import registry as TR
from repro_torch.core import schemes as TS
from repro_torch.core.registry import StageArgs
from repro_torch.kernels import ops as tops

M, D = 512, 4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("agsparse", "sparcml", "sparse_ps", "omnireduce", "balanced")


def _kwargs(name: str, n: int) -> dict:
    """Small capacities, so the Zipf stream overflows some of them."""
    return {"agsparse": dict(capacity=32),
            "sparcml": dict(n=n, capacity=32),
            "sparse_ps": dict(n=n, cap_push=16, cap_pull=32),
            "omnireduce": dict(n=n, block=4, cap_push=8, cap_pull=16),
            "balanced": dict(n=n, cap_push=16)}[name]


@functools.lru_cache(maxsize=None)
def _workers(seed, n, m, density, dtype, d, dyadic):
    """(reference [n, m(, d)] jax array, the same values as torch)."""
    key = jax.random.PRNGKey(seed)
    masks = metrics.synth_sparse_masks(key, n, m, density)
    shape = (n, m) if d is None else (n, m, d)
    vals = jax.random.normal(key, shape)
    if dyadic:
        vals = jnp.round(vals * 8)
    if d is not None:
        masks = masks[..., None]
    jd, td = DTYPES[dtype]
    v = (vals * masks).astype(jd)
    return v, torch.from_numpy(np.array(v.astype(jnp.float32))).to(td)


def _ref(name: str, v, **kw):
    """The reference's ``simulate`` of ``<name>_sync`` on ``v``, jitted."""
    return jax.jit(functools.partial(S.simulate, getattr(S, f"{name}_sync"),
                                     **kw))(v)


def _assert_sync_equal(got, ref, what=""):
    out, st = got
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref[0].astype(jnp.float32)),
                                  err_msg=what)
    np.testing.assert_array_equal(st.sent_words.numpy(),
                                  np.asarray(ref[1].sent_words), err_msg=what)
    np.testing.assert_array_equal(st.overflow.numpy(),
                                  np.asarray(ref[1].overflow), err_msg=what)


def _check_both_routes(name, tv, ref, **kw):
    for backend in ("torch", "cuda"):
        tops.reset_counts()
        got = TS.simulate(getattr(TS, f"{name}_sync"), tv, backend=backend,
                          **kw)
        assert got[0].dtype == tv.dtype
        _assert_sync_equal(got, ref, f"{name} backend={backend}")
        plain = tops.PLAIN_CALLS["coo_scatter_add"]
        # "cuda" on CPU tensors takes the kernel's plain version, counted
        assert (plain > 0) == (backend == "cuda"), (backend, plain)
        assert sum(tops.LAUNCHES.values()) == 0


CASES = [(name, n) for name in NAMES for n in (2, 4, 8)]


@pytest.mark.parametrize("values", ["dyadic", "random"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["element", "row"])
@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-n{b}" for a, b in CASES])
def test_scheme_bitwise_vs_reference(name, n, mode, dtype, values):
    v, tv = _workers(1, n, M, 0.05, dtype, None if mode == "element" else D,
                     values == "dyadic")
    kw = _kwargs(name, n)
    ref = _ref(name, v, **kw)
    _check_both_routes(name, tv, ref, **kw)


def test_skewed_stream_overflows_the_imbalanced_schemes():
    """One Zipf stream at n = 8: the range-partitioned schemes overflow
    their small per-range capacities (the imbalance cost) and count it as
    the reference does; agsparse at the same capacity overflows too."""
    n = 8
    v, tv = _workers(5, n, M, 0.2, "f32", None, True)
    for name in NAMES:
        kw = _kwargs(name, n)
        ref = _ref(name, v, **kw)
        assert int(np.asarray(ref[1].overflow).sum()) > 0, name
        _check_both_routes(name, tv, ref, **kw)


@pytest.mark.parametrize("name,kw", [
    ("balanced", dict(cap_push=128)),             # n * cap_push = 1024 > M
    ("balanced", dict(cap_push=96, cap_pull=600, bins=1000)),
    ("agsparse", dict(capacity=M + 9)),
    ("sparse_ps", dict(cap_push=M, cap_pull=M)),  # past the range length
    ("omnireduce", dict(block=8, cap_push=40, cap_pull=100)),
])
def test_capacities_past_the_tensor_length(name, kw):
    n = 8
    v, tv = _workers(2, n, M, 0.2, "bf16", D, False)
    if name != "agsparse":
        kw = dict(kw, n=n)
    ref = _ref(name, v, **kw)
    assert int(np.asarray(ref[1].overflow).sum()) == 0
    _check_both_routes(name, tv, ref, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_stage_sync_provisioned_equals_direct_call(name):
    """``stage_sync`` with ``stage_args_for``'s capacities is the scheme's
    own call with the registry's aliases and defaults applied, and both
    equal the reference's ``stage_sync`` under ``simulate``."""
    n = 4
    v, tv = _workers(3, n, M, 0.05, "f32", D, True)
    for backend in ("torch", "cuda"):
        args = TS.stage_args_for(name, rows=M, budget=0.1, backend=backend)
        got = TS.stage_sync(name, tv, group=TS.SimGroup(n), n=n,
                            stage_args=args)
        ref_args = S.stage_args_for(name, rows=M, budget=0.1)
        ref = jax.vmap(functools.partial(
            S.stage_sync, name, axis=S.AXIS, n=n, stage_args=ref_args),
            axis_name=S.AXIS)(v)
        _assert_sync_equal(got, ref, f"{name} {backend}")
        kw = {k: v_ for k, v_ in TR.stage_kwargs(
            TR.get_scheme(name), args).items()}
        if TR.get_scheme(name).needs_n:
            kw["n"] = n
        direct = TS.simulate(getattr(TS, f"{name}_sync"), tv, **kw)
        _assert_sync_equal(direct, ref, f"{name} direct {backend}")


# ---------------------------------------------------------------------------
# stage_sync's registry dispatch: the reference's config-named errors
# ---------------------------------------------------------------------------

def _port_call(scheme, **kw):
    return TS.stage_sync(scheme, torch.zeros((2, 8)), group=TS.SimGroup(2),
                         n=2, **kw)


def _ref_call(scheme, **kw):
    return S.stage_sync(scheme, jnp.zeros((8,)), axis="x", n=2, **kw)


@pytest.mark.parametrize("scheme,kw,pattern", [
    ("bogus", {}, "registered schemes are"),
    ("agsparse", dict(capacity=4, block=2), "does not consume stage arg"),
    ("balanced", {}, "requires stage arg"),
    ("zen", {}, "layout"),
    ("agsparse", dict(capacity=4, stage_args="typed"), "not both"),
    ("agsparse", dict(capasity=4), "unknown stage arg"),
])
def test_stage_sync_errors_match_reference(scheme, kw, pattern):
    if kw.get("stage_args") == "typed":
        port_kw = dict(kw, stage_args=StageArgs(capacity=4))
        ref_kw = dict(kw, stage_args=RefStageArgs(capacity=4))
    else:
        port_kw = ref_kw = kw
    with pytest.raises(ValueError, match=pattern) as port:
        _port_call(scheme, **port_kw)
    with pytest.raises(ValueError, match=pattern) as ref:
        _ref_call(scheme, **ref_kw)
    # the same message up to its first parenthesis (where the reference
    # names its axis or its module)
    assert str(port.value).split(" (")[0] == str(ref.value).split(" (")[0]


@pytest.mark.parametrize("name,n,m,kw", [
    ("sparcml", 3, 12, dict(capacity=4)),
    ("sparcml", 6, 12, dict(capacity=4)),
    ("sparse_ps", 4, 14, dict(cap_push=4, cap_pull=4)),
    ("sparse_ps", 3, 16, dict(cap_push=4, cap_pull=4)),
    ("omnireduce", 4, 24, dict(block=4, cap_push=2, cap_pull=2)),
    ("omnireduce", 3, 16, dict(block=2, cap_push=2, cap_pull=2)),
])
def test_divisibility_errors_match_reference_and_feasibility(name, n, m, kw):
    with pytest.raises(ValueError) as ref:
        S.simulate(getattr(S, f"{name}_sync"), jnp.zeros((n, m)), n=n, **kw)
    with pytest.raises(ValueError) as port:
        TS.simulate(getattr(TS, f"{name}_sync"), torch.zeros((n, m)), n=n,
                    **kw)
    assert str(port.value) == str(ref.value)
    if name != "omnireduce":   # the planner never picks omnireduce
        assert not TC._feasible(name, n, m)


@pytest.mark.parametrize("name,n,m", [("sparcml", 4, 12), ("sparcml", 8, 16),
                                      ("sparse_ps", 3, 12),
                                      ("sparse_ps", 8, 16)])
def test_feasible_configurations_run(name, n, m):
    assert TC._feasible(name, n, m)
    out, st = TS.simulate(getattr(TS, f"{name}_sync"), torch.ones((n, m)),
                          n=n, capacity=m) if name == "sparcml" else \
        TS.simulate(getattr(TS, f"{name}_sync"), torch.ones((n, m)), n=n,
                    cap_push=m, cap_pull=m)
    assert torch.equal(out, torch.full((n, m), float(n)))
    assert not st.overflow.any()


def test_ppermute_and_rank_ids_on_the_simulated_group():
    g = TS.SimGroup(4)
    x = torch.arange(8.0).view(4, 2)
    got = g.ppermute(x, [(i, i ^ 1) for i in range(4)])
    assert torch.equal(got, x[[1, 0, 3, 2]])
    # a worker that receives nothing gets zeros (lax.ppermute)
    assert torch.equal(g.ppermute(x, [(0, 1)])[[0, 2, 3]], torch.zeros(3, 2))
    assert g.rank_ids("cpu").tolist() == [0, 1, 2, 3]
