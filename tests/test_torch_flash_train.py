"""Port parity: the trainer's memory-bounded step (``ops.FlashAttn``,
``layers.lm_head_loss_chunked``, the per-layer recompute of
``models/model.py``) against the reference's ``flash_attention`` under
``jax.vjp``, its ``lm_head_loss_chunked`` and its ``train_loss``, on the
CPU (the kernels' plain versions).

* ``FlashAttn`` (the plain route: ``flash_fwd_op`` on CPU tensors, the
  blockwise ``flash_bwd_ref``) at small blocks (``chunk`` 16, ``q_chunk``
  32, so that several of each are crossed): the output and dq, dk, dv
  within 2e-5 of each tensor's largest reference magnitude in f32 (f32
  sums in another order); a bf16 q on f32 K/V (whisper's cross-attention
  in training) within one bf16 ulp where the result is bf16.
* The chunked LM-head loss at S not a multiple of 512, with masked labels
  and a padded vocab: the loss and the gradients of x and w.
* The reduced dense trainer at S = 1100 (the real 512-key chunks, 1024-row
  q blocks and 512-position head chunks all crossed): the loss and every
  leaf's gradient.
* On the meta device a narrow 2-layer qwen2 train step at S = 4096 makes
  no buffer as large as one head's S x S f32 scores.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models.common import make_ctx
from repro.models.model import build_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.layers import Linear, lm_head_loss_chunked
from repro_torch.models.model import Model

F32_TOL = 2e-5      # of the largest |reference| of each compared tensor
CHUNK, Q_CHUNK = 16, 32

# (B, Sq, Sk, H, KV, hd, hd_v, causal, window)
ATTN_CASES = {
    "causal-gqa": (2, 70, 70, 4, 2, 16, 16, True, 0),
    "window": (1, 80, 80, 2, 1, 8, 8, True, 20),
    "encoder": (2, 50, 50, 2, 2, 8, 8, False, 0),
    "cross": (2, 40, 45, 4, 2, 8, 8, False, 0),
    "mla-widths": (1, 60, 60, 3, 3, 12, 8, True, 0),
}


def _attn_inputs(B, Sq, Sk, H, KV, hd, hd_v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd_v), dtype=np.float32),
            rng.standard_normal((B, Sq, H, hd_v), dtype=np.float32))


def _reference_vjp(q, k, v, do, causal, window):
    """(out, (dq, dk, dv)) of the reference's flash_attention as f32
    numpy."""
    out, vjp = jax.vjp(lambda a, b, c: RL.flash_attention(
        a, b, c, causal=causal, window=window, chunk=CHUNK,
        q_chunk=Q_CHUNK), q, k, v)
    grads = vjp(do.astype(out.dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(q, k, v, do, causal, window):
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.FlashAttn.apply(*ins, causal, window, 0, CHUNK, Q_CHUNK, False)
    out.backward(do.to(out.dtype))
    return out.detach(), [t.grad for t in ins]


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=F32_TOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attn_matches_reference_vjp(case):
    B, Sq, Sk, H, KV, hd, hd_v, causal, window = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(B, Sq, Sk, H, KV, hd, hd_v, seed=len(case))
    want, wgrads = _reference_vjp(*(jnp.asarray(a) for a in (q, k, v, do)),
                                  causal, window)
    ops.reset_counts()
    out, grads = _port(*(torch.as_tensor(a) for a in (q, k, v, do)), causal,
                       window)
    # the CPU tensors took the kernel's plain version once, then its
    # plain backward once; nothing launched
    assert ops.PLAIN_CALLS["flash_fwd"] == 1
    assert ops.RECOMPUTE_CALLS["flash_fwd"] == 1
    assert not any(ops.LAUNCHES.values())
    assert out.shape == (B, Sq, H, hd_v) and out.dtype == torch.float32
    _close(out, want, "out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, wgrads):
        assert g.dtype == torch.float32
        _close(g, w, name)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


def test_flash_attn_bf16_q_on_f32_kv_matches_reference():
    """Whisper's cross-attention in training: q in bf16 (the model's
    dtype), K/V in f32 (the encoder's activations).  Both promote q to
    f32 and return q's dtype: the output and dq are the reference's to
    one bf16 ulp (their f32 values rounded once), dk and dv to 2e-5."""
    B, Sq, Sk, H, KV, hd = 2, 33, 50, 4, 2, 8
    q, k, v, do = _attn_inputs(B, Sq, Sk, H, KV, hd, hd, seed=5)
    jq = jnp.asarray(q, jnp.bfloat16)
    want, wgrads = _reference_vjp(jq, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(do, jnp.bfloat16), False, 0)
    tq = torch.as_tensor(q).to(torch.bfloat16)
    out, grads = _port(tq, torch.as_tensor(k), torch.as_tensor(v),
                       torch.as_tensor(do), False, 0)
    assert out.dtype == grads[0].dtype == torch.bfloat16
    assert grads[1].dtype == grads[2].dtype == torch.float32
    for name, g, w in (("out", out, want), ("dq", grads[0], wgrads[0])):
        err = np.abs(g.float().numpy() - w)
        gate = _bf16_ulp(w) + F32_TOL * float(np.abs(w).max())
        assert (err <= gate).all(), (name, float(err.max()))
    _close(grads[1], wgrads[1], "dk")
    _close(grads[2], wgrads[2], "dv")


def test_lm_head_loss_chunked_matches_reference():
    """S = 1100 (three chunks of 512, the last padded), labels masked at
    random, a vocab of 200 padded to 256: the loss and the gradients of x
    and w within 2e-5 of their largest reference magnitude."""
    B, S, d, V, Vp = 2, 1100, 32, 200, 256
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, d), dtype=np.float32)
    w = (rng.standard_normal((d, Vp), dtype=np.float32) / np.sqrt(d))
    w[:, V:] = 0
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    ctx = make_ctx(ref_get_config("qwen2-0.5b").reduced(), 1, 1)

    def ref_loss(xa, wa):
        lj = jnp.asarray(labels)
        return RL.lm_head_loss_chunked({"lm_head_w": wa}, "lm_head", xa, lj,
                                       ctx, mask=lj >= 0, valid_vocab=V)

    want, (wx, ww) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    head = Linear(d, Vp, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        head.w.copy_(torch.as_tensor(w))
    tx = torch.as_tensor(x).requires_grad_()
    loss = lm_head_loss_chunked(head, tx, torch.as_tensor(labels).long(), V)
    loss.backward()
    assert abs(loss.item() - float(want)) <= F32_TOL * abs(float(want))
    _close(tx.grad, np.asarray(wx), "dx")
    _close(head.w.grad, np.asarray(ww), "dw")


SEQ_TRAIN = 1100


def test_reduced_trainer_at_s1100_matches_reference():
    """qwen2-0.5b reduced (2 layers, d 256, 4 / 2 heads of 64) in f32, one
    sequence of 1100 with a fifth of its labels masked: the loss within
    1e-4 and every leaf's gradient within 1e-4 of its largest reference
    magnitude (f32 sums over 1100 positions in another order).  Each
    layer's attention runs twice (its forward and its recompute) and its
    blockwise backward once."""
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-0.5b").reduced(),
                                  dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype=torch.float32)
    ref_model = build_model(ref_cfg, make_ctx(ref_cfg, 1, 1))
    params = ref_model.init(jax.random.PRNGKey(0))[0]
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (1, SEQ_TRAIN)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[rng.random(labels.shape) < 0.2] = -1
    (want, _), ref_g = jax.jit(jax.value_and_grad(ref_model.train_loss,
                                                 has_aux=True))(
        params, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})

    port = Model(cfg, device="cpu")
    port.load_reference_params(jax.tree.map(np.asarray, params))
    ops.reset_counts()
    loss = port(torch.as_tensor(tokens).long(), torch.as_tensor(labels).long())
    loss.backward()
    assert ops.PLAIN_CALLS["flash_fwd"] == 2 * cfg.n_layers
    assert ops.RECOMPUTE_CALLS["flash_fwd"] == cfg.n_layers
    assert abs(loss.item() - float(want)) < 1e-4, (loss.item(), float(want))
    grads = dict(port.named_leaves())
    for name, path, idx in port.reference_leaves():
        node = ref_g
        for key in path:
            node = node[key]
        rg = np.asarray(node)[idx] if idx else np.asarray(node)
        np.testing.assert_allclose(grads[name].grad.numpy(), rg, rtol=0,
                                   atol=1e-4 * float(np.abs(rg).max()) + 1e-9,
                                   err_msg=name)


class _LargestBuffer(TorchDispatchMode):
    """The bytes of the largest tensor any op makes under it."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel() * t.element_size())
        return out


def test_train_step_makes_no_sxs_buffer_on_meta():
    """A 2-layer qwen2 (the reduced widths, bf16) step at one sequence of
    4096 on the meta device: no op makes a tensor as large as one head's
    f32 scores (S x S x 4 bytes = 64 MiB; the plain attention this slice
    removed made H of them a layer).  The largest transients are the
    blockwise backward's (q_chunk x H x chunk f32)."""
    S = 4096
    cfg = get_config("qwen2-0.5b").reduced()
    model = Model(cfg, device="meta")
    tok = torch.zeros((1, S), dtype=torch.long, device="meta")
    ops.reset_counts()
    with _LargestBuffer() as mode:
        model(tok, tok).backward()
    assert ops.RECOMPUTE_CALLS["flash_fwd"] == cfg.n_layers
    assert model.layers[0].attn.q.w.grad is not None
    assert mode.largest < S * S * 4, mode.largest
    assert mode.largest >= 1024 * cfg.n_heads * 512 * 4
