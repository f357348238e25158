"""Cache writes: per-token decode writes take a batched scatter above
_SCATTER_MIN_B rows and must be byte-identical to the small-B unrolled
dynamic-update-slice path; the batcher's chunked admission always takes the
scatter and must equal a row-by-row write (incl. inactive-row preservation
via the out-of-bounds-drop trick)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastertransformer4codefuse_tpu.engine import kv_cache as kvc


def _mk_cache(rng, L, B, nH, S, dh, quant):
    if quant:
        return {
            "k": jnp.asarray(rng.integers(-90, 90, (L, B, nH, S, dh)), jnp.int8),
            "v": jnp.asarray(rng.integers(-90, 90, (L, B, nH, S, dh)), jnp.int8),
            "k_s": jnp.asarray(rng.uniform(0.01, 0.1, (L, B, nH, S)), jnp.bfloat16),
            "v_s": jnp.asarray(rng.uniform(0.01, 0.1, (L, B, nH, S)), jnp.bfloat16),
        }
    return {
        "k": jnp.asarray(rng.normal(size=(L, B, nH, S, dh)), jnp.float32),
        "v": jnp.asarray(rng.normal(size=(L, B, nH, S, dh)), jnp.float32),
    }


@pytest.mark.parametrize("quant", [False, True])
def test_write_decode_scatter_matches_unrolled(quant, monkeypatch):
    rng = np.random.default_rng(0)
    L, B, nH, S, dh = 2, 12, 2, 16, 8  # B=12 > _SCATTER_MIN_B
    cache = _mk_cache(rng, L, B, nH, S, dh, quant)
    k = jnp.asarray(rng.normal(size=(B, 1, nH, dh)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(B, 1, nH, dh)), jnp.float32)
    pos = jnp.asarray(rng.integers(0, S, B), jnp.int32)

    got = kvc.write_decode(dict(cache), jnp.int32(1), k, v, pos)
    monkeypatch.setattr(kvc, "_SCATTER_MIN_B", 1000)  # force unrolled
    want = kvc.write_decode(dict(cache), jnp.int32(1), k, v, pos)
    for key in cache:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


def _chunk_rowwise(cache, layer, k, v, pos, active):
    """Row-by-row numpy reference of write_chunk."""
    out = {n: np.array(x) for n, x in cache.items()}
    quant = "k_s" in cache
    for b in range(k.shape[0]):
        if not bool(active[b]):
            continue
        p, C = int(pos[b]), k.shape[1]
        for name, t in (("k", k[b]), ("v", v[b])):
            t = jnp.swapaxes(t, 0, 1)  # [nH, C, dh]
            if quant:
                q, sc = kvc._quantize_vec(t)
                out[name][layer, b, :, p:p + C] = np.asarray(q)
                out[name + "_s"][layer, b, :, p:p + C] = np.asarray(sc)
            else:
                out[name][layer, b, :, p:p + C] = np.asarray(t, out[name].dtype)
    return out


def _check_chunk(rng, B, quant):
    L, nH, S, dh, C = 2, 2, 24, 8, 4
    cache = _mk_cache(rng, L, B, nH, S, dh, quant)
    k = jnp.asarray(rng.normal(size=(B, C, nH, dh)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(B, C, nH, dh)), jnp.float32)
    pos = jnp.asarray(rng.integers(0, S - C + 1, B), jnp.int32)
    active = jnp.asarray(rng.integers(0, 2, B), jnp.bool_)  # mixed rows
    got = kvc.write_chunk(dict(cache), jnp.int32(1), k, v, pos, active)
    want = _chunk_rowwise(cache, 1, k, v, pos, active)
    for key in cache:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key])
    # inactive rows' bytes are bit-preserved
    for b in range(B):
        if not bool(active[b]):
            np.testing.assert_array_equal(
                np.asarray(got["k"][:, b]), np.asarray(cache["k"][:, b])
            )


@pytest.mark.parametrize("quant", [False, True])
def test_write_chunk_scatter_matches_unrolled(quant):
    _check_chunk(np.random.default_rng(1), 12, quant)


@pytest.mark.parametrize("B", [1, 3])
def test_write_chunk_small_pool_matches_rowwise(B):
    """A pool of a few slots (B <= _SCATTER_MIN_B) writes its chunks with
    the same scatter."""
    _check_chunk(np.random.default_rng(2 + B), B, True)


def test_write_chunk_drops_tokens_past_capacity():
    """A chunk that runs past the slab's end writes its in-bounds tokens and
    drops the rest (per token, not the whole row)."""
    rng = np.random.default_rng(7)
    L, B, nH, S, dh, C = 2, 2, 2, 16, 8, 4
    cache = _mk_cache(rng, L, B, nH, S, dh, False)
    k = jnp.asarray(rng.normal(size=(B, C, nH, dh)), jnp.float32)
    pos = jnp.asarray([S - 2, 3], jnp.int32)
    got = kvc.write_chunk(dict(cache), jnp.int32(0), k, k, pos, jnp.ones(B, bool))
    want = np.array(cache["k"])
    want[0, 0, :, S - 2:] = np.swapaxes(np.asarray(k[0, :2]), 0, 1)
    want[0, 1, :, 3:3 + C] = np.swapaxes(np.asarray(k[1]), 0, 1)
    np.testing.assert_array_equal(np.asarray(got["k"]), want)


@pytest.mark.parametrize("write", ["chunk", "decode_wide"])
@pytest.mark.parametrize("quant", [False, True])
def test_cache_writes_keep_slab_layout(write, quant):
    """The compiled writes scatter into the slab as laid out: no transpose of
    a slab (an index naming only the layer, row and position axes makes
    XLA's scatter canonicalization move them to the front, copying the whole
    stacked slab twice per write)."""
    rng = np.random.default_rng(9)
    L, nH, S, dh = 2, 2, 32, 8
    B, C = (4, 8) if write == "chunk" else (12, 1)
    cache = _mk_cache(rng, L, B, nH, S, dh, quant)
    k = jnp.zeros((B, C, nH, dh), jnp.float32)
    pos = jnp.zeros((B,), jnp.int32)
    if write == "chunk":
        fn = lambda c, k, p: kvc.write_chunk(c, jnp.int32(1), k, k, p, p >= 0)
    else:
        fn = lambda c, k, p: kvc.write_decode(c, jnp.int32(1), k, k, p)
    hlo = jax.jit(fn, donate_argnums=0).lower(cache, k, pos).compile().as_text()
    slab_dims = {f"[{L},{B},{nH},{S}", f"[{L},{B},{S},{nH}"}
    moved = [ln for ln in hlo.splitlines() if "transpose(" in ln
             and any(d in ln for d in slab_dims)]
    assert not moved, moved
