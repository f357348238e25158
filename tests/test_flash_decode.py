"""Interpret-mode coverage of the Triton decode-attention kernel.

Asserts the chunked online-softmax kernel (ops/flash_decode.py) matches the
XLA attend_decode path on int8 and float caches, across positions that
exercise the per-row loop bound (chunks wholly past ``pos`` are never read;
their data must never leak into the output). Reference behavior
being matched: the fused masked-MHA decode kernel
(/root/reference/src/fastertransformer/kernels/decoder_masked_multihead_attention.cu),
which likewise reads only the valid [0, tlength] prefix of the cache.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu.ops.flash_decode import flash_decode_stacked


def _make_cache(rng, L, B, nH, S, dh, quantized):
    if quantized:
        cache = {
            "k": jnp.asarray(rng.integers(-127, 128, (L, B, nH, S, dh)), jnp.int8),
            "v": jnp.asarray(rng.integers(-127, 128, (L, B, nH, S, dh)), jnp.int8),
            "k_s": jnp.asarray(rng.random((L, B, nH, S)) * 0.02, jnp.bfloat16),
            "v_s": jnp.asarray(rng.random((L, B, nH, S)) * 0.02, jnp.bfloat16),
        }
    else:
        cache = {
            "k": jnp.asarray(rng.standard_normal((L, B, nH, S, dh)), jnp.bfloat16),
            "v": jnp.asarray(rng.standard_normal((L, B, nH, S, dh)), jnp.bfloat16),
        }
    return cache


@pytest.mark.parametrize(
    "B,nH,dh,S,quantized,pos",
    [
        (1, 8, 128, 640, True, 15),  # pos inside first chunk: clamp skips the rest
        (1, 8, 128, 640, True, 500),
        (2, 4, 128, 384, True, 383),  # full cache valid
        (2, 4, 128, 384, False, 100),  # float cache (no scale operands)
        (1, 2, 256, 256, True, 200),  # dh=256
    ],
)
def test_flash_decode_matches_xla(B, nH, dh, S, quantized, pos):
    rng = np.random.default_rng(0)
    L = 2
    cache = _make_cache(rng, L, B, nH, S, dh, quantized)
    q = jnp.asarray(rng.standard_normal((B, nH, dh)), jnp.bfloat16)
    sm = 1.0 / float(np.sqrt(dh))
    positions = jnp.asarray([(pos + 31 * i) % S for i in range(B)], jnp.int32)
    valid = jnp.arange(S)[None, :] <= positions[:, None]

    ref = kvc.attend_decode(cache, jnp.int32(1), q, valid, sm, positions=positions)
    out = flash_decode_stacked(
        q, cache["k"], cache.get("k_s"), cache["v"], cache.get("v_s"),
        jnp.int32(1), positions, sm_scale=sm, bs=256, interpret=True,
    )
    err = jnp.max(jnp.abs(out.astype(jnp.float32) - ref.astype(jnp.float32)))
    assert float(err) < 0.05, float(err)


def test_flash_decode_clamp_ignores_stale_tail():
    """Poison the cache past ``pos`` with huge values: the clamped chunks and
    masked lanes must not change the output at all."""
    rng = np.random.default_rng(1)
    B, nH, dh, S, L = 1, 4, 128, 512, 1
    cache = _make_cache(rng, L, B, nH, S, dh, quantized=False)
    pos = 100
    poisoned = dict(cache)
    k = np.asarray(cache["k"], np.float32)
    v = np.asarray(cache["v"], np.float32)
    k[..., pos + 1 :, :] = 1e4
    v[..., pos + 1 :, :] = np.nan
    poisoned["k"] = jnp.asarray(k, jnp.bfloat16)
    poisoned["v"] = jnp.asarray(v, jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((B, nH, dh)), jnp.bfloat16)
    positions = jnp.full((B,), pos, jnp.int32)
    args = dict(sm_scale=0.088, bs=128, interpret=True)
    clean = flash_decode_stacked(
        q, cache["k"], None, cache["v"], None, jnp.int32(0), positions, **args
    )
    dirty = flash_decode_stacked(
        q, poisoned["k"], None, poisoned["v"], None, jnp.int32(0), positions, **args
    )
    assert jnp.array_equal(clean, dirty), "stale tail leaked into flash-decode output"


def _bruteforce_beam(cache, layer, q, valid, sm, indir, bw):
    """float64 numpy: row r's position s reads physical row
    group(r)*bw + indir[r, s] of the cache."""
    k = np.asarray(cache["k"][layer], np.float64)
    v = np.asarray(cache["v"][layer], np.float64)
    if "k_s" in cache:
        k = k * np.asarray(cache["k_s"][layer], np.float64)[..., None]
        v = v * np.asarray(cache["v_s"][layer], np.float64)[..., None]
    qf = np.asarray(q, np.float64)
    BB, nH, dh = qf.shape
    S = k.shape[2]
    out = np.zeros((BB, nH, dh))
    for r in range(BB):
        src = (r // bw) * bw + np.asarray(indir[r])  # [S] physical rows
        kr = k[src, :, np.arange(S)]  # [S, nH, dh]
        vr = v[src, :, np.arange(S)]
        sc = np.einsum("hd,shd->hs", qf[r], kr) * sm
        sc = np.where(np.asarray(valid[r])[None, :], sc, -np.inf)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        out[r] = np.einsum("hs,shd->hd", p, vr)
    return out


@pytest.mark.parametrize(
    "B,bw,nH,dh,S,quantized",
    [
        (1, 2, 8, 128, 640, True),
        (2, 4, 4, 128, 512, True),
        (1, 3, 4, 128, 384, False),  # odd beam width, float cache
    ],
)
def test_flash_decode_beam_matches_xla(B, bw, nH, dh, S, quantized):
    """The XLA beam path (all-pairs scores + one-hot indirection selects)
    must match a brute-force float64 gather of each beam's history, at the
    shapes the removed beam kernel was tested at."""
    rng = np.random.default_rng(1)
    L = 2
    BB = B * bw
    cache = _make_cache(rng, L, BB, nH, S, dh, quantized)
    if not quantized:
        cache = {k: v.astype(jnp.float32) for k, v in cache.items()}
    q = jnp.asarray(rng.standard_normal((BB, nH, dh)), jnp.float32)
    # heterogeneous per-beam lengths exercise the per-row causal bounds
    positions = jnp.asarray(rng.integers(S // 4, S - 1, (BB,)), jnp.int32)
    valid = jnp.arange(S)[None, :] <= positions[:, None]
    indir = jnp.asarray(rng.integers(0, bw, (BB, S)), jnp.int32)
    layer = 1

    got = kvc.attend_decode_beam(cache, jnp.int32(layer), q, valid, 0.11, indir, bw)
    want = _bruteforce_beam(cache, layer, q, valid, 0.11, indir, bw)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize(
    "B,nH,nKV,dh,S,quantized,pos",
    [
        (1, 8, 2, 128, 640, True, 500),   # GQA g=4, int8 cache
        (2, 8, 4, 128, 384, False, 100),  # GQA g=2, float cache
        (1, 4, 1, 128, 512, True, 300),   # MQA (single KV head)
    ],
)
def test_flash_decode_gqa_matches_xla(B, nH, nKV, dh, S, quantized, pos):
    """GQA/MQA: the kernel's per-KV-head M=g query dot must match the XLA
    grouped attend (the path LLaMA-family decode used exclusively before)."""
    rng = np.random.default_rng(3)
    L = 2
    cache = _make_cache(rng, L, B, nKV, S, dh, quantized)
    if not quantized:
        # the float-cache GQA REFERENCE path (attend_chunk) does a bf16 PV
        # einsum the CPU backend's thunks reject at this shape — compare in
        # f32 on CPU (the kernel itself is dtype-agnostic)
        cache = {k: v.astype(jnp.float32) for k, v in cache.items()}
    q = jnp.asarray(
        rng.standard_normal((B, nH, dh)),
        jnp.bfloat16 if quantized else jnp.float32,
    )
    sm = 1.0 / float(np.sqrt(dh))
    positions = jnp.asarray([(pos + 17 * i) % S for i in range(B)], jnp.int32)
    valid = jnp.arange(S)[None, :] <= positions[:, None]

    ref = kvc.attend_decode(cache, jnp.int32(1), q, valid, sm, positions=positions)
    out = flash_decode_stacked(
        q, cache["k"], cache.get("k_s"), cache["v"], cache.get("v_s"),
        jnp.int32(1), positions, sm_scale=sm, bs=256, interpret=True,
    )
    err = jnp.max(jnp.abs(out.astype(jnp.float32) - ref.astype(jnp.float32)))
    assert float(err) < 0.05, float(err)


@pytest.mark.parametrize(
    "S,dh,ps,ok",
    [
        (1152, 128, 0, True),  # the 13B one-shot cache: 1024 + 128
        (2048, 128, 256, True),  # the served paged pool
        (640, 256, 0, True),
        (13, 128, 0, False),  # a tiny engine's odd cache length
        (1024, 80, 0, False),  # head dim not a power of two
        (2048, 128, 8, False),  # pages smaller than one 16-position chunk
    ],
)
def test_kernel_choice_gate(S, dh, ps, ok):
    """attend_decode takes the kernel only for shapes it tiles."""
    from fastertransformer4codefuse_tpu.ops.flash_decode import supported

    assert supported(S, dh, ps) is ok


def test_int8_slab_read_as_int16_words():
    """The int16 view of an int8 slab keeps every byte: lane j of word i is
    element 2i + j, sign-extended."""
    from fastertransformer4codefuse_tpu.ops.flash_decode import _bits, _words

    x = jnp.asarray(np.arange(-128, 128, dtype=np.int8).reshape(2, 128))
    w = _words(x)
    assert w.dtype == jnp.int16 and w.shape == (2, 64)
    lo, hi = _bits(w, 0, 8), _bits(w, 8, 8)
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(x[:, 0::2], np.float32))
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(x[:, 1::2], np.float32))


@pytest.mark.parametrize("in_pool", [False, True])
def test_dense_slab_takes_kernel_under_route(in_pool, monkeypatch):
    """With the engine's decode route on, a dense slab takes the kernel in
    the one-shot engine and in a slot pool's tick alike, and the tokens equal
    the XLA path's."""
    from fastertransformer4codefuse_tpu import (
        ContinuousBatcher, GptNeoXConfig, GptNeoXEngine, RuntimeConfig, init_params,
    )
    from fastertransformer4codefuse_tpu.ops import flash_decode as fd
    from fastertransformer4codefuse_tpu.ops.routes import Routes

    calls = []
    real = fd.flash_decode_stacked
    monkeypatch.setattr(
        fd, "flash_decode_stacked", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    cfg = GptNeoXConfig.tiny(head_num=4, size_per_head=16, vocab_size=64)
    params = init_params(cfg, dtype="fp32")
    prompts, out_len = [[3, 4, 5, 6, 7], [9, 8]], 16  # one-shot cache: 16 + 16

    def run(eng):
        if not in_pool:
            out = eng.generate(prompts, output_len=out_len, top_k=1)
            return out.output_ids[:, 0].tolist()
        cb = ContinuousBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=8)
        uids = [cb.submit(p, out_len, top_k=1) for p in prompts]
        done = cb.run(max_ticks=100)
        return [done[u].output_ids for u in uids]

    rt = RuntimeConfig(dtype="fp32", seq_bucket=16)
    want = run(GptNeoXEngine(cfg, params, rt))
    assert not calls
    eng = GptNeoXEngine(cfg, params, rt)
    eng.routes = Routes(flash_decode=True, interpret=True)
    assert run(eng) == want
    assert calls
