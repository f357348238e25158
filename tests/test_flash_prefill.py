"""cuDNN-route prefill attention vs the einsum path at the dispatch boundary.

On the GPU, prefill attention can run through ``jax.nn.dot_product_attention``
(cuDNN's fused flash attention, ops/attention.prefill_attention_fused) — the
library analog of the reference's TRT fused MHA cubins, which are held to its
unfused bmm+softmax path (GptContextAttentionLayer.cc:195-310 chooses per
arch, both must agree). On the CPU the same wrapper runs with
``implementation="xla"``, which exercises its length/padding masks and the
zeroing of padded rows; cuDNN itself is compared on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.ops import attention as att
from fastertransformer4codefuse_tpu.ops import routes


def _qkv(rng, B, S, nH, dh, nKV=None, dtype=jnp.float32):
    mk = lambda h: jnp.asarray(rng.standard_normal((B, S, h, dh)), dtype)
    return mk(nH), mk(nKV or nH), mk(nKV or nH)


@pytest.mark.parametrize(
    "B,S,lengths",
    [
        (1, 2048, [2048]),  # full length
        (2, 2048, [2048, 1300]),  # ragged: right-padding via per-row lengths
    ],
)
def test_flash_prefill_matches_fused_at_boundary(B, S, lengths):
    rng = np.random.default_rng(0)
    nH, dh = 1, 128
    q, k, v = _qkv(rng, B, S, nH, dh)
    input_lengths = jnp.asarray(lengths, jnp.int32)
    sm = 1.0 / float(np.sqrt(dh))
    mask = att.make_prefill_mask(input_lengths, S)
    ref = att.prefill_attention(q, k, v, mask, sm)  # einsum path (no lengths)
    out = att.prefill_attention_fused(q, k, v, input_lengths, sm, implementation="xla")
    for b, ln in enumerate(lengths):
        err = jnp.max(jnp.abs(out[b, :ln] - ref[b, :ln]))
        assert float(err) < 1e-4, (b, float(err))
        # padded rows come out zero (finite for the layers above)
        assert float(jnp.max(jnp.abs(out[b, ln:]))) == 0.0 if ln < S else True


@pytest.mark.parametrize("nH,nKV", [(4, 4), (8, 2), (4, 1)])
def test_fused_prefill_gqa_and_padding(nH, nKV):
    """Grouped and multi-query heads through the wrapper equal the einsum
    path's grouped contraction on every live row; padded rows are zero."""
    rng = np.random.default_rng(1)
    B, S, dh = 2, 48, 16
    q, k, v = _qkv(rng, B, S, nH, dh, nKV)
    lens = jnp.asarray([48, 29], jnp.int32)
    ref = att.prefill_attention(q, k, v, att.make_prefill_mask(lens, S), 0.25)
    out = att.prefill_attention_fused(q, k, v, lens, 0.25, implementation="xla")
    live = np.arange(S)[None, :] < np.asarray(lens)[:, None]
    np.testing.assert_allclose(
        np.asarray(out)[live], np.asarray(ref)[live], atol=1e-5, rtol=1e-5
    )
    assert not np.asarray(out)[~live].any()


def test_flash_gate_boundaries():
    # cuDNN takes 16-bit operands with a head dim that is a multiple of 8, <= 128
    mk = lambda dh, dt: jnp.zeros((1, 8, 2, dh), dt)
    assert att.fused_prefill_ok(mk(128, jnp.bfloat16))
    assert att.fused_prefill_ok(mk(64, jnp.float16))
    assert not att.fused_prefill_ok(mk(128, jnp.float32))
    assert not att.fused_prefill_ok(mk(256, jnp.bfloat16))
    assert not att.fused_prefill_ok(mk(80 + 4, jnp.bfloat16))


def test_prefill_dispatch_takes_fused_route_only_when_enabled(monkeypatch):
    """prefill_attention routes to the fused wrapper only with the engine
    flag set, per-row lengths given and a 16-bit operand."""
    calls = []
    monkeypatch.setattr(
        att, "prefill_attention_fused",
        lambda q, k, v, n, sm: calls.append(q.dtype) or jnp.zeros_like(q),
    )
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 16, 2, 32, dtype=jnp.bfloat16)
    lens = jnp.asarray([16], jnp.int32)
    mask = att.make_prefill_mask(lens, 16)
    att.prefill_attention(q, k, v, mask, 0.2, lens)
    assert calls == []  # flag off (the CPU default)
    with routes.use(routes.Routes(flash_prefill=True)):
        att.prefill_attention(q, k, v, mask, 0.2)  # no lengths: einsum
        assert calls == []
        att.prefill_attention(q.astype(jnp.float32), k, v, mask, 0.2, lens)
        assert calls == []  # float32 operands: einsum
        att.prefill_attention(q, k, v, mask, 0.2, lens)
        assert calls == [jnp.bfloat16]
