"""Paged KV cache (engine/paged_kv.py): write/read equivalence against the
dense slab cache, the block-table flash kernel (interpret mode) against the
XLA gather path, and the host-side page allocator."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu.core.config import GptNeoXConfig
from fastertransformer4codefuse_tpu.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu.engine import paged_kv as paged


CFG = GptNeoXConfig.tiny(head_num=4, size_per_head=16, layer_num=2)
PS = 8  # page size (tiny for tests)
B, NPG = 3, 4  # slots, pages per slot
S = PS * NPG


def scrambled_tables(rng, n_pages):
    """Block tables with non-contiguous, shuffled page assignment (the real
    allocator pops from a free list, so physical order is arbitrary)."""
    ids = rng.permutation(np.arange(1, n_pages))[: B * NPG]
    return jnp.asarray(ids.reshape(B, NPG).astype(np.int32))


def mk_pair(dtype, rng):
    """(dense cache, paged cache with scrambled tables) both empty."""
    dense = kvc.init_cache(CFG, B, S, dtype)
    pg = paged.init_paged_cache(
        CFG, B, S, n_pages=B * NPG + 3, page_size=PS, dtype=dtype
    )
    pg["pt"] = scrambled_tables(rng, B * NPG + 3)
    return dense, pg


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8])
def test_paged_write_decode_matches_dense(dtype):
    rng = np.random.RandomState(0)
    dense, pg = mk_pair(dtype, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    for layer in range(CFG.layer_num):
        for step in range(5):
            k = jnp.asarray(rng.randn(B, 1, nKV, dh), jnp.float32)
            v = jnp.asarray(rng.randn(B, 1, nKV, dh), jnp.float32)
            posn = jnp.asarray(rng.randint(0, S, size=(B,)), jnp.int32)
            dense = kvc.write_decode(dense, layer, k, v, posn)
            pg = kvc.write_decode(pg, layer, k, v, posn)
        gat = paged.gather_layer_dense(pg, layer)
        for name in gat:
            want = np.asarray(dense[name][layer])
            np.testing.assert_array_equal(np.asarray(gat[name]), want)


def test_paged_write_decode_skip_hits_garbage_page():
    rng = np.random.RandomState(1)
    _, pg = mk_pair(jnp.float32, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    k = jnp.ones((B, 1, nKV, dh), jnp.float32)
    posn = jnp.asarray([2, 3, 4], jnp.int32)
    skip = jnp.asarray([False, True, False])
    pg2 = kvc.write_decode(pg, 0, k, 2 * k, posn, skip=skip)
    gat = paged.gather_layer_dense(pg2, 0)
    assert np.asarray(gat["k"][0, :, 2]).max() == 1.0  # row 0 written
    assert np.asarray(gat["k"][1]).max() == 0.0  # row 1 untouched (skip)
    # the garbage page absorbed the skipped write
    assert np.asarray(pg2["pk"][0, 0]).max() == 1.0


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8])
def test_paged_write_chunk_matches_dense(dtype):
    rng = np.random.RandomState(2)
    dense, pg = mk_pair(dtype, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    C = PS // 2  # prompt bucket divides page size
    for layer in range(CFG.layer_num):
        for start in range(0, S, C):
            k = jnp.asarray(rng.randn(B, C, nKV, dh), jnp.float32)
            v = jnp.asarray(rng.randn(B, C, nKV, dh), jnp.float32)
            pos = jnp.full((B,), start, jnp.int32)
            active = jnp.asarray([True, start < S // 2, True])
            dense = kvc.write_chunk(dense, layer, k, v, pos, active)
            pg = kvc.write_chunk(pg, layer, k, v, pos, active)
        gat = paged.gather_layer_dense(pg, layer)
        for name in gat:
            np.testing.assert_array_equal(
                np.asarray(gat[name]), np.asarray(dense[name][layer])
            )


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8])
def test_paged_attend_decode_matches_dense(dtype):
    rng = np.random.RandomState(3)
    dense, pg = mk_pair(dtype, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    posn = jnp.asarray([5, 11, 30], jnp.int32)
    for layer in range(CFG.layer_num):
        for p in range(int(posn.max()) + 1):
            k = jnp.asarray(rng.randn(B, 1, nKV, dh), jnp.float32)
            v = jnp.asarray(rng.randn(B, 1, nKV, dh), jnp.float32)
            pp = jnp.minimum(posn, p)
            dense = kvc.write_decode(dense, layer, k, v, pp)
            pg = kvc.write_decode(pg, layer, k, v, pp)
    q = jnp.asarray(rng.randn(B, CFG.head_num, dh), jnp.float32)
    valid = jnp.arange(S)[None, :] <= posn[:, None]
    a_d = kvc.attend_decode(dense, 1, q, valid, 0.25, positions=posn)
    a_p = kvc.attend_decode(pg, 1, q, valid, 0.25, positions=posn)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_d), atol=1e-5)


def test_paged_attend_chunk_matches_dense_gqa():
    """GQA (nKV < nH): the paged chunk attention folds query groups exactly
    like the dense path."""
    cfg = GptNeoXConfig.tiny(
        head_num=4, size_per_head=16, layer_num=1, kv_head_num=2,
        qkv_layout="concat",
    )
    rng = np.random.RandomState(4)
    dense = kvc.init_cache(cfg, B, S, jnp.float32)
    pg = paged.init_paged_cache(
        cfg, B, S, n_pages=B * NPG + 2, page_size=PS, dtype=jnp.float32
    )
    pg["pt"] = scrambled_tables(rng, B * NPG + 2)
    C = PS
    nKV, dh = cfg.kv_heads, cfg.size_per_head
    for start in range(0, S // 2, C):
        k = jnp.asarray(rng.randn(B, C, nKV, dh), jnp.float32)
        v = jnp.asarray(rng.randn(B, C, nKV, dh), jnp.float32)
        pos = jnp.full((B,), start, jnp.int32)
        act = jnp.ones((B,), bool)
        dense = kvc.write_chunk(dense, 0, k, v, pos, act)
        pg = kvc.write_chunk(pg, 0, k, v, pos, act)
    q = jnp.asarray(rng.randn(B, 2, cfg.head_num, dh), jnp.float32)
    posc = jnp.asarray([[3, 4], [9, 10], [14, 15]], jnp.int32)
    valid = jnp.arange(S)[None, None, :] <= posc[:, :, None]
    a_d = kvc.attend_chunk(dense, 0, q, valid, 0.25)
    a_p = kvc.attend_chunk(pg, 0, q, valid, 0.25)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_d), atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_flash_decode_paged_interpret_parity(quant, g):
    """The block-table kernel (interpret mode) against the XLA gather path,
    at kernel-real shapes (dh=128, page 256)."""
    from fastertransformer4codefuse_tpu.ops.flash_decode import flash_decode_paged

    cfg = GptNeoXConfig.tiny(
        head_num=2 * g, size_per_head=128, layer_num=1,
        kv_head_num=2 if g > 1 else None,
        qkv_layout="concat" if g > 1 else "interleaved",
    )
    ps, npg, nb = 256, 3, 2
    Sl = ps * npg
    rng = np.random.RandomState(5)
    pg = paged.init_paged_cache(
        cfg, nb, Sl, n_pages=nb * npg + 2, page_size=ps,
        dtype=jnp.int8 if quant else jnp.float32,
    )
    ids = rng.permutation(np.arange(1, nb * npg + 2))[: nb * npg]
    pg["pt"] = jnp.asarray(ids.reshape(nb, npg).astype(np.int32))
    nKV, dh = cfg.kv_heads, cfg.size_per_head
    posn = jnp.asarray([300, 520], jnp.int32)
    for p in range(int(posn.max()) + 1):
        k = jnp.asarray(rng.randn(nb, 1, nKV, dh), jnp.float32)
        v = jnp.asarray(rng.randn(nb, 1, nKV, dh), jnp.float32)
        pg = kvc.write_decode(pg, 0, k, v, jnp.minimum(posn, p))
    q = jnp.asarray(rng.randn(nb, cfg.head_num, dh), jnp.float32)
    valid = jnp.arange(Sl)[None, :] <= posn[:, None]
    want = kvc.attend_chunk(pg, 0, q[:, None], valid[:, None, :], 0.1)[:, 0]
    got = flash_decode_paged(
        q, pg["pk"], pg.get("pk_s"), pg["pv"], pg.get("pv_s"),
        jnp.int32(0), posn, pg["pt"], sm_scale=0.1, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-2, rtol=2e-2)


def test_page_allocator():
    al = paged.PageAllocator(10)  # pages 1..9 usable
    assert al.free_pages == 9
    assert al.pages_needed(257, 256) == 2
    a = al.alloc(4)
    assert len(set(a)) == 4 and 0 not in a
    assert not al.can(6)
    al.release(a)
    assert al.can(9) and not al.can(10)


@pytest.mark.parametrize("kind", ["int4", "int8k_int4v"])
def test_paged_packed_write_decode_matches_dense(kind):
    """Nibble-packed pages: decode RMW writes produce byte-identical slabs
    to the dense packed cache."""
    rng = np.random.RandomState(7)
    dense = kvc.init_cache(CFG, B, S, kind)
    pg = paged.init_paged_cache(
        CFG, B, S, n_pages=B * NPG + 3, page_size=PS, dtype=kind
    )
    pg["pt"] = scrambled_tables(rng, B * NPG + 3)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    for layer in range(CFG.layer_num):
        for step in range(6):
            k = jnp.asarray(rng.randn(B, 1, nKV, dh), jnp.float32)
            v = jnp.asarray(rng.randn(B, 1, nKV, dh), jnp.float32)
            posn = jnp.asarray(rng.randint(0, S, size=(B,)), jnp.int32)
            dense = kvc.write_decode(dense, layer, k, v, posn)
            pg = kvc.write_decode(pg, layer, k, v, posn)
        gat = paged.gather_layer_dense(pg, layer)
        want = kvc._unpack_layer({
            n: dense[n][layer] for n in dense
        })
        for name in gat:
            np.testing.assert_array_equal(
                np.asarray(gat[name]), np.asarray(want[name]), err_msg=name
            )


def test_paged_packed_chunk_equals_decode_writes():
    """A C-wide packed chunk write must equal C per-position decode writes
    (same per-vector quantization either way)."""
    rng = np.random.RandomState(8)
    mk = lambda: paged.init_paged_cache(
        CFG, B, S, n_pages=B * NPG + 2, page_size=PS, dtype="int4"
    )
    pt = scrambled_tables(rng, B * NPG + 2)
    a, bcache = mk(), mk()
    a["pt"] = pt
    bcache["pt"] = pt
    C = PS // 2  # even
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    k = jnp.asarray(rng.randn(B, C, nKV, dh), jnp.float32)
    v = jnp.asarray(rng.randn(B, C, nKV, dh), jnp.float32)
    start = jnp.full((B,), PS, jnp.int32)  # page-aligned chunk start
    a = kvc.write_chunk(a, 0, k, v, start, jnp.ones((B,), bool))
    for c in range(C):
        bcache = kvc.write_decode(
            bcache, 0, k[:, c: c + 1], v[:, c: c + 1], start + c
        )
    ga, gb = paged.gather_layer_dense(a, 0), paged.gather_layer_dense(bcache, 0)
    for name in ga:
        np.testing.assert_array_equal(np.asarray(ga[name]), np.asarray(gb[name]))


@pytest.mark.parametrize("kind", ["int4", "int8k_int4v"])
def test_flash_decode_paged_packed_interpret_parity(kind):
    """Block-table kernel over PACKED pages (interpret) vs the XLA gather
    path, at kernel-real shapes."""
    from fastertransformer4codefuse_tpu.ops.flash_decode import flash_decode_paged
    from fastertransformer4codefuse_tpu.engine.paged_kv import _slab

    cfg = GptNeoXConfig.tiny(head_num=2, size_per_head=128, layer_num=1)
    ps, npg, nb = 256, 3, 2
    Sl = ps * npg
    rng = np.random.RandomState(9)
    pg = paged.init_paged_cache(
        cfg, nb, Sl, n_pages=nb * npg + 2, page_size=ps, dtype=kind
    )
    ids = rng.permutation(np.arange(1, nb * npg + 2))[: nb * npg]
    pg["pt"] = jnp.asarray(ids.reshape(nb, npg).astype(np.int32))
    nKV, dh = cfg.kv_heads, cfg.size_per_head
    posn = jnp.asarray([300, 520], jnp.int32)
    for p in range(int(posn.max()) + 1):
        k = jnp.asarray(rng.randn(nb, 1, nKV, dh), jnp.float32)
        v = jnp.asarray(rng.randn(nb, 1, nKV, dh), jnp.float32)
        pg = kvc.write_decode(pg, 0, k, v, jnp.minimum(posn, p))
    q = jnp.asarray(rng.randn(nb, cfg.head_num, dh), jnp.float32)
    valid = jnp.arange(Sl)[None, :] <= posn[:, None]
    want = kvc.attend_chunk(pg, 0, q[:, None], valid[:, None, :], 0.1)[:, 0]
    got = flash_decode_paged(
        q, _slab(pg, "pk"), pg.get("pk_s"), _slab(pg, "pv"), pg.get("pv_s"),
        jnp.int32(0), posn, pg["pt"], sm_scale=0.1, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=3e-2, rtol=3e-2
    )


@pytest.mark.parametrize("kind", [jnp.int8, "int4", jnp.float32])
@pytest.mark.parametrize("g", [1, 2])
def test_flash_chunk_paged_interpret_parity(kind, g):
    """Chunked-prefill attention over a PAGED pool (the XLA page-gather path,
    GQA folded into the query axis) against a brute-force float64 reference
    built from the same written K/V, at the shapes the removed paged chunk
    kernel was tested at (page 256, a chunk straddling a page edge)."""
    from fastertransformer4codefuse_tpu.engine.paged_kv import gather_layer_dense

    cfg = GptNeoXConfig.tiny(
        head_num=2 * g, size_per_head=128, layer_num=1,
        kv_head_num=2 if g > 1 else None,
        qkv_layout="concat" if g > 1 else "interleaved",
    )
    ps, npg, nb, C = 256, 3, 2, 8
    Sl = ps * npg
    rng = np.random.RandomState(11)
    pg = paged.init_paged_cache(
        cfg, nb, Sl, n_pages=nb * npg + 2, page_size=ps, dtype=kind
    )
    ids = rng.permutation(np.arange(1, nb * npg + 2))[: nb * npg]
    pg["pt"] = jnp.asarray(ids.reshape(nb, npg).astype(np.int32))
    nKV, dh = cfg.kv_heads, cfg.size_per_head
    starts = jnp.asarray([248, 512], jnp.int32)  # one straddles a page edge
    for p in range(int(starts.max())):
        k = jnp.asarray(rng.randn(nb, 1, nKV, dh), jnp.float32)
        v = jnp.asarray(rng.randn(nb, 1, nKV, dh), jnp.float32)
        pg = kvc.write_decode(pg, 0, k, v, jnp.minimum(starts, p))
    kc = jnp.asarray(rng.randn(nb, C, nKV, dh), jnp.float32)
    vc = jnp.asarray(rng.randn(nb, C, nKV, dh), jnp.float32)
    pg = kvc.write_chunk(pg, 0, kc, vc, starts, jnp.ones((nb,), bool))

    q = jnp.asarray(rng.randn(nb, C, cfg.head_num, dh), jnp.float32)
    posc = starts[:, None] + jnp.arange(C)[None, :]
    valid = jnp.arange(Sl)[None, None, :] <= posc[:, :, None]
    got = np.asarray(kvc.attend_chunk(pg, 0, q, valid, 0.1), np.float64)

    dense = gather_layer_dense(pg, 0)  # dequantize the stored values
    kd = np.asarray(dense["k"], np.float64)
    vd = np.asarray(dense["v"], np.float64)
    if "k_s" in dense:
        kd = kd * np.asarray(dense["k_s"], np.float64)[..., None]
        vd = vd * np.asarray(dense["v_s"], np.float64)[..., None]
    qf = np.asarray(q, np.float64).reshape(nb, C, nKV, g, dh)
    sc = np.einsum("bckgd,bksd->bckgs", qf, kd) * 0.1
    sc = np.where(np.asarray(valid)[:, :, None, None, :], sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bckgs,bksd->bckgd", p, vd).reshape(nb, C, cfg.head_num, dh)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_paged_small_packed_pages_fall_back_not_crash():
    """Packed pools with small pages (128 positions) route through the decode
    kernel (interpret mode here) and the chunk path must just work — and
    agree with the XLA gather path."""
    cfg = GptNeoXConfig.tiny(head_num=2, size_per_head=128, layer_num=1)
    ps, npg, nb = 128, 4, 2
    Sl = ps * npg
    rng = np.random.RandomState(12)
    pg = paged.init_paged_cache(
        cfg, nb, Sl, n_pages=nb * npg + 2, page_size=ps, dtype="int4"
    )
    ids = rng.permutation(np.arange(1, nb * npg + 2))[: nb * npg]
    pg["pt"] = jnp.asarray(ids.reshape(nb, npg).astype(np.int32))
    nKV, dh = cfg.kv_heads, cfg.size_per_head
    posn = jnp.asarray([3, 9], jnp.int32)
    for p in range(int(posn.max()) + 1):
        k = jnp.asarray(rng.randn(nb, 1, nKV, dh), jnp.float32)
        v = jnp.asarray(rng.randn(nb, 1, nKV, dh), jnp.float32)
        pg = kvc.write_decode(pg, 0, k, v, jnp.minimum(posn, p))
    q = jnp.asarray(rng.randn(nb, cfg.head_num, dh), jnp.float32)
    valid = jnp.arange(Sl)[None, :] <= posn[:, None]
    want = kvc.attend_decode(pg, 0, q, valid, 0.25, positions=posn)
    from fastertransformer4codefuse_tpu.ops import routes

    with routes.use(routes.Routes(flash_decode=True, interpret=True)):
        out = kvc.attend_decode(pg, 0, q, valid, 0.25, positions=posn)
        outc = kvc.attend_chunk(pg, 0, q[:, None], valid[:, None, :], 0.25)
    assert np.isfinite(np.asarray(out)).all()
    assert np.isfinite(np.asarray(outc)).all()
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_paged_unknown_dtype_string_rejected():
    with pytest.raises(ValueError):
        paged.init_paged_cache(CFG, B, S, n_pages=4, page_size=PS, dtype="int8")
