"""KV cache: dense preallocated slabs — bf16, int8, or nibble-packed int4.

The analog of the reference's key_cache_/value_cache_ buffers
(/root/reference/src/fastertransformer/models/gptneox/GptNeoX.cc:84-156,
including its x16-byte vectorized K layout, GptNeoX.cc:551-561 — here the
layout question reduces to keeping [S, dh] contiguous per (batch, head)).

INT8 mode stores one symmetric scale per cached vector (per layer, batch,
head, position), halving the HBM traffic of decode attention — the analog of
BitDecoding/KV-quant practice; the reference has no KV quantization at all.

INT4 mode goes further: adjacent SEQUENCE positions pack two-per-byte (slot
2i in the low nibble, 2i+1 in the high), quartering the bf16 cache's decode-attention bytes. Packed slabs use
the keys ``k4``/``v4`` ([L,B,nKV,S/2,dh] int8) so every consumer can tell the
format from the pytree alone; scales stay per UNPACKED position. Because K's
quantization error lands inside the softmax logits while V's only blurs the
convex combination, a hybrid mode keeps K at int8 and packs only V
(``kv_cache_dtype="int8k_int4v"``) — see QUALITY.md for measured deltas.

Cache pytree per layer: {"k"|"k4": ..., "v"|"v4": ...} plus {"k_s": [B,nH,S],
"v_s": ...} when quantized. Stacked over layers for lax.scan.
"""
from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..core.config import GptNeoXConfig
from ..ops import flash_decode, routes

Cache = Dict[str, jax.Array]


def init_cache(
    config: GptNeoXConfig, batch: int, max_seq_len: int, dtype=jnp.bfloat16
) -> Cache:
    """``dtype``: a jnp dtype, or the strings "int4" (K and V packed) /
    "int8k_int4v" (K int8, V packed)."""
    shape = (
        config.layer_num,
        batch,
        config.kv_heads,  # < head_num under GQA (LLaMA family)
        max_seq_len,
        config.size_per_head,
    )
    kind = dtype if isinstance(dtype, str) else None
    if kind in ("int4", "int8k_int4v"):
        assert max_seq_len % 2 == 0, "int4 KV packs sequence-position pairs"
        pshape = shape[:3] + (max_seq_len // 2, shape[4])
        c = {
            "k_s": jnp.zeros(shape[:-1], jnp.bfloat16),
            "v_s": jnp.zeros(shape[:-1], jnp.bfloat16),
            "v4": jnp.zeros(pshape, jnp.int8),
        }
        if kind == "int4":
            c["k4"] = jnp.zeros(pshape, jnp.int8)
        else:
            c["k"] = jnp.zeros(shape, jnp.int8)
        return c
    if dtype == jnp.int8:
        c = {
            "k": jnp.zeros(shape, jnp.int8),
            "v": jnp.zeros(shape, jnp.int8),
            "k_s": jnp.zeros(shape[:-1], jnp.bfloat16),
            "v_s": jnp.zeros(shape[:-1], jnp.bfloat16),
        }
    else:
        c = {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}
    return c


def quantized(cache_l: Cache) -> bool:
    return "k_s" in cache_l


def packed4(cache_l: Cache, which: str) -> bool:
    """True when slab ``which`` ("k"/"v") is stored nibble-packed."""
    return f"{which}4" in cache_l


def seq_len_of(cache: Cache) -> int:
    """Unpacked sequence capacity (packed slabs halve their S axis; paged
    caches report their LOGICAL capacity n_pages_per_slot * page_size)."""
    if "pt" in cache:
        from . import paged_kv as _paged

        return _paged.logical_seq_len(cache)
    if "k_s" in cache:
        return cache["k_s"].shape[-1]
    return cache["k"].shape[-2]


def _quantize_vec(x: jax.Array, qmax: float = 127.0) -> Tuple[jax.Array, jax.Array]:
    """Per-vector symmetric int8/int4 over the last (dh) axis.
    x [..., dh] -> (q [..., dh] int8, scale [...])."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    scale = jnp.where(amax > 0, amax / qmax, 1.0)
    q = jnp.round(xf / scale[..., None]).astype(jnp.int8)
    return q, scale.astype(jnp.bfloat16)


def _pack_seq_pairs(q: jax.Array, axis: int = -2) -> jax.Array:
    """Pack int4-valued int8 rows two-per-byte along ``axis`` (the sequence
    axis): byte i = (q[2i+1] << 4) | (q[2i] & 0xF) — the weight kernels'
    bitcast nibble order."""
    S = q.shape[axis]
    assert S % 2 == 0
    lo = jax.lax.slice_in_dim(q, 0, S, stride=2, axis=axis % q.ndim)
    hi = jax.lax.slice_in_dim(q, 1, S, stride=2, axis=axis % q.ndim)
    return jnp.left_shift(hi, 4) | (lo & 0xF)


def _unpack_seq_pairs(p: jax.Array, axis: int = -2) -> jax.Array:
    """Inverse of _pack_seq_pairs: [.., S/2, ..] int8 -> [.., S, ..] int8 with
    sign-extended nibbles (the XLA paths; the decode kernel splits the
    nibbles in registers)."""
    lo = jnp.left_shift(p, 4) >> 4  # arithmetic shift sign-extends
    hi = p >> 4
    stacked = jnp.stack([lo, hi], axis=axis % p.ndim + 1)
    shape = list(p.shape)
    shape[axis % p.ndim] *= 2
    return stacked.reshape(shape)


def _unpack_layer(cache_l: Cache) -> Cache:
    """Layer view with packed slabs expanded to int8 (the XLA paths)."""
    out = dict(cache_l)
    if "k4" in out:
        out["k"] = _unpack_seq_pairs(out.pop("k4"))
    if "v4" in out:
        out["v"] = _unpack_seq_pairs(out.pop("v4"))
    return out


def write_prefill(cache: Cache, layer: jax.Array, k: jax.Array, v: jax.Array) -> Cache:
    """Write positions [0, S) of layer ``layer`` IN PLACE on the full stacked
    cache (k, v: [B, S, nH, dh]; cache slabs [L, B, nH, Smax, dh]).

    The cache is threaded through the layer scan as carry and updated with
    dynamic-update-slices at the layer index — passing per-layer slices through
    scan xs/ys instead forces XLA to re-assemble (copy) the whole stacked slab
    every engine step."""
    kt = k.transpose(0, 2, 1, 3)[None]
    vt = v.transpose(0, 2, 1, 3)[None]
    out = dict(cache)
    zero5 = (layer, 0, 0, 0, 0)
    zero4 = (layer, 0, 0, 0)

    def wq(name, t):
        if packed4(cache, name):
            assert t.shape[3] % 2 == 0, "int4 KV prefill width must be even"
            q, s = _quantize_vec(t, 7.0)
            out[name + "4"] = jax.lax.dynamic_update_slice(
                cache[name + "4"], _pack_seq_pairs(q), zero5
            )
        else:
            q, s = _quantize_vec(t)
            out[name] = jax.lax.dynamic_update_slice(cache[name], q, zero5)
        out[name + "_s"] = jax.lax.dynamic_update_slice(cache[name + "_s"], s, zero4)

    if quantized(cache):
        wq("k", kt)
        wq("v", vt)
    else:
        out["k"] = jax.lax.dynamic_update_slice(cache["k"], kt.astype(cache["k"].dtype), zero5)
        out["v"] = jax.lax.dynamic_update_slice(cache["v"], vt.astype(cache["v"].dtype), zero5)
    return out


def write_prefix(cache: Cache, k_pre: jax.Array, v_pre: jax.Array) -> Cache:
    """Write prefix-prompt K/V states into cache slots [0, P) of EVERY layer.

    k_pre/v_pre: [L, B, nH, P, dh] float — a task's saved key/value states,
    placed ahead of the input exactly like the reference's prefix-prompt
    preload (kernels/unfused_attention_kernels.cu:1370-1394 copies the raw
    prompt K/V into the cache head; no rotary is applied to them). Rows whose
    real prompt is shorter than P leave garbage in their tail slots — those
    slots sit at cache positions the row's input/decode writes overwrite
    before they ever become attention-valid, so no masked_tokens buffer is
    needed (the repo's contiguous per-row layout vs the reference's
    p p x x i i padding scheme, GptNeoX.cc:461-463)."""
    assert not (packed4(cache, "k") or packed4(cache, "v")), (
        "prompt learning requires an unpacked KV cache (int8/bf16): prefix "
        "widths are per-row and may straddle int4 position-pair bytes"
    )
    out = dict(cache)
    zero5 = (0, 0, 0, 0, 0)
    zero4 = (0, 0, 0, 0)
    if quantized(cache):
        kq, ks = _quantize_vec(k_pre)
        vq, vs = _quantize_vec(v_pre)
        out["k"] = jax.lax.dynamic_update_slice(cache["k"], kq, zero5)
        out["v"] = jax.lax.dynamic_update_slice(cache["v"], vq, zero5)
        out["k_s"] = jax.lax.dynamic_update_slice(cache["k_s"], ks, zero4)
        out["v_s"] = jax.lax.dynamic_update_slice(cache["v_s"], vs, zero4)
    else:
        out["k"] = jax.lax.dynamic_update_slice(
            cache["k"], k_pre.astype(cache["k"].dtype), zero5
        )
        out["v"] = jax.lax.dynamic_update_slice(
            cache["v"], v_pre.astype(cache["v"].dtype), zero5
        )
    return out


# Above this batch size, per-token cache writes use ONE batched scatter per
# slab; at or below it, B unrolled dynamic-update-slices, which alias in
# place. A wide pool (B=32) needs the O(1)-ops scatter to keep the step
# program from bloating.
_SCATTER_MIN_B = 8


def _scatter_rows(B: int) -> bool:
    return B > _SCATTER_MIN_B


def _scatter_tokens(slab: jax.Array, layer, rows: jax.Array, cols: jax.Array,
                    new: jax.Array) -> jax.Array:
    """slab[layer, rows[i], :, cols[i]] = new[i] for slab [L, B, nH, S(, dh)]
    and new [N, nH(, dh)]; out-of-bounds ``cols`` are dropped.

    The index vector names every slab axis in order (head and dh offsets 0).
    ``slab.at[layer, rows, :, cols]`` names axes (0, 1, 3) only, and XLA's
    scatter canonicalization then moves those axes to the front: two
    transposes of the whole stacked slab (all layers) per write."""
    zero = jnp.zeros_like(rows)
    idx = [jnp.full_like(rows, layer), rows, zero, cols] + [zero] * (slab.ndim - 4)
    dnums = jax.lax.ScatterDimensionNumbers(
        update_window_dims=tuple(range(1, slab.ndim - 2)),
        inserted_window_dims=(0, 1, 3),
        scatter_dims_to_operand_dims=tuple(range(slab.ndim)),
    )
    return jax.lax.scatter(
        slab, jnp.stack(idx, axis=-1), new.astype(slab.dtype), dnums,
        unique_indices=True, mode=jax.lax.GatherScatterMode.FILL_OR_DROP,
    )


def _row_update(slab: jax.Array, layer, new: jax.Array, positions: jax.Array):
    """slab[layer, b, :, positions[b]] = new[b] for slab [L, B, nH, S, ...]."""
    B = new.shape[0]
    if _scatter_rows(B):
        return _scatter_tokens(slab, layer, jnp.arange(B), positions, new)
    for b in range(B):  # small B: unrolled in-place DUS (see _SCATTER_MIN_B)
        if slab.ndim == 4:  # scale slab [L, B, nH, S], new [B, nH]
            upd = new[b][None, None, :, None]
            idx = (layer, b, 0, positions[b])
        else:  # value slab [L, B, nH, S, dh], new [B, nH, dh]
            upd = new[b][None, :, None, :][None]
            idx = (layer, b, 0, positions[b], 0)
        slab = jax.lax.dynamic_update_slice(slab, upd, idx)
    return slab


def _read_rows(slab: jax.Array, layer, positions: jax.Array) -> jax.Array:
    """slab[layer, b, :, positions[b]] -> [B, nH] or [B, nH, dh].

    Unrolled per-row dynamic slices, NOT an advanced-indexing gather: the
    gather's XLA lowering may prefer the slab position-major, and in a
    program that also runs a Pallas kernel on the slab that preference
    materializes as full-slab relayout copies per layer. Dynamic slices are
    layout-agnostic."""
    B = positions.shape[0]
    if B > _SCATTER_MIN_B * 2:  # single gather
        return slab[layer, jnp.arange(B), :, positions]
    rows = []
    for b in range(B):
        if slab.ndim == 4:  # scale slab [L, B, nH, S] -> [nH]
            r = jax.lax.dynamic_slice(
                slab, (layer, b, 0, positions[b]), (1, 1, slab.shape[2], 1)
            )[0, 0, :, 0]
        else:  # value slab [L, B, nH, S, dh] -> [nH, dh]
            r = jax.lax.dynamic_slice(
                slab,
                (layer, b, 0, positions[b], 0),
                (1, 1, slab.shape[2], 1, slab.shape[4]),
            )[0, 0, :, 0, :]
        rows.append(r)
    return jnp.stack(rows)


def write_decode(
    cache: Cache, layer, k: jax.Array, v: jax.Array, positions: jax.Array,
    skip=None, skip_mode: str = "preserve",
) -> Cache:
    """Write one token per row into layer ``layer`` (k, v: [B, 1, nH, dh]).

    ``skip`` [B] bool marks rows whose write must not disturb readable cache
    state. Two mechanisms:

    - ``skip_mode="preserve"`` (beam search): the row's bytes at ``positions``
      are kept EXACTLY — under cache indirection a finished row's slots may be
      referenced by other beams, including its own current position (the
      reference never faces this: its finished rows stop stepping,
      GptNeoX.cc:1031-1033). Costs a read-modify-write gather; fine inside a
      one-shot program where the cache never crosses a jit boundary.
    - ``skip_mode="sacrifice_last"`` (continuous batcher): skipped rows write
      their garbage to slot S-1 instead. Safe for the pool because every slot
      is rewritten by its OWNING row before it first becomes attention-valid
      (decode writes position p before attending over it; chunk prefill writes
      [pos, pos+C) before those become valid), and crucially LAYOUT-NEUTRAL:
      the preserve gather's XLA lowering wants the slab position-major, which
      in the pool's per-tick program materialized as two full-slab relayout
      copies per LAYER)."""
    if "pt" in cache:
        # paged pool: skip rows write the garbage page (layout-neutral, like
        # sacrifice_last — see engine/paged_kv.py); skip_mode is moot
        from . import paged_kv as _paged

        return _paged.write_decode_paged(cache, layer, k, v, positions, skip)
    kt = k[:, 0]  # [B, nH, dh]
    vt = v[:, 0]
    out = dict(cache)
    if skip is not None and skip_mode == "sacrifice_last":
        positions = jnp.where(skip, seq_len_of(cache) - 1, positions)
        skip = None  # plain positional writes from here on

    def upd(slab, new):
        return _row_update(slab, layer, new.astype(slab.dtype), positions)

    def keep(new, slab):
        # "preserve" only (the packed-w4 path read-modify-writes anyway)
        if skip is None:
            return new
        old = _read_rows(slab, layer, positions).astype(new.dtype)
        mask = skip.reshape((-1,) + (1,) * (new.ndim - 1))
        return jnp.where(mask, old, new)

    def w4(name, t):
        """Packed int4 slab write: read-modify-write the position-pair byte.
        Even slots overwrite the whole byte (the high nibble belongs to the
        NEXT, not-yet-written slot); odd slots merge over the low nibble."""
        slab = cache[name + "4"]
        q, s = _quantize_vec(t, 7.0)
        byte_pos = positions // 2
        odd = (positions % 2 == 1).reshape(-1, 1, 1)
        old = _read_rows(slab, layer, byte_pos)
        new = jnp.where(odd, (old & 0x0F) | jnp.left_shift(q, 4), q & 0xF)
        if skip is not None:
            new = jnp.where(skip.reshape(-1, 1, 1), old, new)
        out[name + "4"] = _row_update(slab, layer, new, byte_pos)
        out[name + "_s"] = _row_update(
            cache[name + "_s"], layer, keep(s, cache[name + "_s"]), positions
        )

    if quantized(cache):
        for name, t in (("k", kt), ("v", vt)):
            if packed4(cache, name):
                w4(name, t)
            else:
                q, s = _quantize_vec(t)
                out[name] = upd(cache[name], keep(q, cache[name]))
                out[name + "_s"] = upd(
                    cache[name + "_s"], keep(s, cache[name + "_s"])
                )
    else:
        out["k"] = upd(cache["k"], keep(kt, cache["k"]))
        out["v"] = upd(cache["v"], keep(vt, cache["v"]))
    return out


def write_chunk(
    cache: Cache, layer, k: jax.Array, v: jax.Array, pos: jax.Array,
    active: jax.Array,
) -> Cache:
    """Write a C-token chunk per row into layer ``layer`` at per-row offsets.

    k, v: [B, C, nH, dh]; pos [B] int32 (chunk start slot per row); active [B]
    bool — rows with active=False keep their existing cache bytes (they may be
    mid-generation while other slots chunk-prefill). Used by the continuous
    batcher's chunked admission (the pool analog of write_prefill)."""
    if "pt" in cache:
        from . import paged_kv as _paged

        return _paged.write_chunk_paged(cache, layer, k, v, pos, active)
    assert not (packed4(cache, "k") or packed4(cache, "v")), (
        "the continuous batcher requires an unpacked KV cache (int8/bf16): "
        "per-row chunk offsets may straddle int4 position-pair bytes"
    )
    out = dict(cache)
    B, C = k.shape[:2]

    # one batched scatter per slab, one token per index. Inactive rows'
    # indices are pushed out of bounds and dropped, so their cache bytes stay
    # untouched without a read-modify-write. (Unrolled per-row
    # read-modify-write slices gave wrong cache contents inside the pool's
    # programs on the H100, PERF.md.)
    S = cache["k"].shape[3]
    cols = (jnp.where(active, pos, S)[:, None] + jnp.arange(C)[None, :]).reshape(-1)
    rows = jnp.repeat(jnp.arange(B), C)

    def supd(slab, new):  # new [B, C, nH(, dh)] -> tokens [B*C, nH(, dh)]
        return _scatter_tokens(slab, layer, rows, cols, new.reshape((B * C,) + new.shape[2:]))

    if quantized(cache):
        kq, ks = _quantize_vec(k)
        vq, vs = _quantize_vec(v)
        out["k"], out["v"] = supd(cache["k"], kq), supd(cache["v"], vq)
        out["k_s"], out["v_s"] = supd(cache["k_s"], ks), supd(cache["v_s"], vs)
    else:
        out["k"], out["v"] = supd(cache["k"], k), supd(cache["v"], v)
    return out


def attend_chunk(
    cache: Cache, layer, q: jax.Array, valid: jax.Array, sm_scale: float,
) -> jax.Array:
    """C-query attention over layer ``layer`` of the full cache.

    q [B, C, nH, dh]; valid [B, C, S] bool (causal-by-position per query).
    Returns [B, C, nH, dh]. The multi-query generalization of attend_decode,
    used for chunked prefill in the continuous batcher. Under GQA (cache has
    nKV < nH heads) the g query heads sharing a KV head fold into the query
    axis — the KV bytes are read once per group, never repeated."""
    B, C, nH, dh = q.shape
    if "pt" in cache:
        from . import paged_kv as _paged

        nKV = _paged._slab(cache, "pk").shape[2]
    else:
        nKV = cache["k_s"].shape[2] if "k_s" in cache else cache["k"].shape[2]
    if nH != nKV:
        g = nH // nKV
        qc = (
            q.reshape(B, C, nKV, g, dh)
            .transpose(0, 1, 3, 2, 4)
            .reshape(B, C * g, nKV, dh)
        )
        out = attend_chunk(cache, layer, qc, jnp.repeat(valid, g, axis=1), sm_scale)
        return (
            out.reshape(B, C, g, nKV, dh)
            .transpose(0, 1, 3, 2, 4)
            .reshape(B, C, nH, dh)
        )
    if "pt" in cache:
        # chunk-prefill attention over the paged pool: gather the pages into
        # a dense per-layer view (leading-axis page gather, layout-neutral —
        # paged_kv.gather_layer_dense). On the GPU, decode ticks ride the
        # paged decode kernel without materializing it.
        from . import paged_kv as _paged

        cache_l = _paged.gather_layer_dense(cache, layer)
    else:
        cache_l = _unpack_layer({
            k: jax.lax.dynamic_index_in_dim(v, layer, axis=0, keepdims=False)
            for k, v in cache.items()
        })
    scores = jnp.einsum(
        "bchd,bhsd->bchs", q, cache_l["k"].astype(q.dtype),
        preferred_element_type=jnp.float32,
    )
    if quantized(cache_l):
        scores = scores * cache_l["k_s"][:, None].astype(jnp.float32)
    scores = scores * sm_scale
    scores = jnp.where(valid[:, :, None, :], scores, MASK_VALUE)
    probs = jax.nn.softmax(scores, axis=-1)
    if quantized(cache_l):
        pv = (probs * cache_l["v_s"][:, None].astype(jnp.float32)).astype(q.dtype)
    else:
        pv = probs.astype(cache_l["v"].dtype)
    out = jnp.einsum(
        "bchs,bhsd->bchd", pv, cache_l["v"].astype(pv.dtype),
        preferred_element_type=jnp.float32,
    )
    return out.astype(q.dtype)


MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def attend_decode_beam(
    cache: Cache,
    layer,
    q: jax.Array,  # [BB, nH, dh]
    valid: jax.Array,  # [BB, S]
    sm_scale: float,
    indir: jax.Array,  # [BB, S] int32 in [0, bw)
    bw: int,
) -> jax.Array:
    """Beam decode attention over a FIXED cache with per-position indirection.

    The analog of the reference's cache_indirection scheme resolved inside the
    decode attention kernel (GptNeoX.cc:776-778, 1011-1017 and the
    decoder_masked_multihead_attention cache_indir parameter): instead of
    physically reordering the [L, BB, nH, S, dh] cache every step, each beam's
    past position s reads physical row ``indir[b, s]`` within its beam group.

    Scores are computed all-pairs within the group
    (target beam j x physical row c) so each cache byte is read ONCE per group,
    then the indirection one-hot selects the right row per position. FLOPs grow
    bw-fold but decode attention is HBM-bound — the eliminated full-cache
    gather copy dominates.

    GQA (nKV < nH, LLaMA family): the g query heads sharing a KV head ride an
    extra einsum axis, so the cache bytes are still read once per beam group —
    the reference decode kernel's head-grouping + cache_indir combination
    (decoder_masked_multihead_attention_template.hpp head_num/kv_head_num).
    """
    cache_l = _unpack_layer({
        k: jax.lax.dynamic_index_in_dim(v, layer, axis=0, keepdims=False)
        for k, v in cache.items()
    })
    BB, S = indir.shape
    B = BB // bw
    nH, dh = q.shape[1], q.shape[2]
    nKV = cache_l["k"].shape[1]
    g = nH // nKV  # query heads per KV head (1 = plain MHA)
    kg = cache_l["k"].reshape(B, bw, nKV, S, dh)
    vg = cache_l["v"].reshape(B, bw, nKV, S, dh)
    # query head h maps to kv head h // g: reshape puts (kv_head, group) in
    # the same order _qkv's head split produces
    qg = q.reshape(B, bw, nKV, g, dh)

    # [B, j, c, nKV, g, S]: every target beam j against every physical row c
    scores_all = jnp.einsum(
        "bjhgd,bchsd->bjchgs", qg, kg.astype(qg.dtype),
        preferred_element_type=jnp.float32,
    )
    if quantized(cache_l):
        k_s = cache_l["k_s"].reshape(B, 1, bw, nKV, 1, S).astype(jnp.float32)
        scores_all = scores_all * k_s
    # one-hot select the physical row per (beam, position)
    sel = jax.nn.one_hot(indir.reshape(B, bw, S), bw, axis=2, dtype=jnp.float32)
    scores = jnp.einsum("bjchgs,bjcs->bjhgs", scores_all, sel) * sm_scale
    validg = valid.reshape(B, bw, 1, 1, S)
    scores = jnp.where(validg, scores, MASK_VALUE)
    probs = jax.nn.softmax(scores, axis=-1)  # [B, j, nKV, g, S]

    # route probs back to physical rows for the PV contraction. NOTE: vg is
    # read unmasked — the indirection contract is that ind[j, s] only selects
    # rows whose written extent covers s (true for real beam histories: an
    # ancestor live at step s wrote position s). Engine caches are zero-init,
    # so even unreferenced unwritten slots are finite.
    pc = jnp.einsum("bjhgs,bjcs->bjchgs", probs, sel)
    if quantized(cache_l):
        v_s = cache_l["v_s"].reshape(B, 1, bw, nKV, 1, S).astype(jnp.float32)
        pc = pc * v_s
    out = jnp.einsum(
        "bjchgs,bchsd->bjhgd", pc.astype(q.dtype), vg.astype(q.dtype),
        preferred_element_type=jnp.float32,
    )
    return out.reshape(BB, nH, dh).astype(q.dtype)


def attend_decode(
    cache: Cache,
    layer,
    q: jax.Array,
    valid: jax.Array,
    sm_scale: float,
    positions=None,
    beam=None,
) -> jax.Array:
    """Single-token attention over layer ``layer`` of the cache.

    q [B, nH, dh]; valid [B, S] bool. Returns [B, nH, dh]. For int8 caches the
    scale factors commute out of both contractions:
      scores = (q . k8) * k_s;   out = sum_s p_s*v_s = (p * v_s) @ v8.
    The layer dynamic-slice fuses into the contractions (read-only).
    """
    S = seq_len_of(cache)
    # routes.flash_decode: the Triton kernel (ops/flash_decode.py) reads only
    # each row's live positions, in place, for dense slabs and paged pools
    route = routes.current()
    if "pt" in cache:
        from . import paged_kv as _paged

        assert beam is None, "paged pools do not support beam search"
        pvs = _paged._slab(cache, "pv")
        dh = pvs.shape[4]
        if (
            route.flash_decode
            and positions is not None
            and flash_decode.supported(S, dh, _paged.page_size(cache))
        ):
            return flash_decode.flash_decode_paged(
                q, _paged._slab(cache, "pk"), cache.get("pk_s"),
                pvs, cache.get("pv_s"), layer, positions, cache["pt"],
                sm_scale=sm_scale, interpret=route.interpret,
            )
        # XLA path: dense view via the leading-axis page gather, then the
        # multi-query math below
        out = attend_chunk(cache, layer, q[:, None], valid[:, None, :], sm_scale)
        return out[:, 0]
    dh = (cache["v4"] if "v4" in cache else cache["v"]).shape[4]
    nKV = cache["k_s"].shape[2] if "k_s" in cache else cache["k"].shape[2]
    if beam is not None:
        bw, indir = beam
        return attend_decode_beam(cache, layer, q, valid, sm_scale, indir, bw)
    if route.flash_decode and positions is not None and flash_decode.supported(S, dh):
        return flash_decode.flash_decode_stacked(
            q, cache.get("k4", cache.get("k")), cache.get("k_s"),
            cache.get("v4", cache.get("v")), cache.get("v_s"),
            layer, positions, sm_scale=sm_scale, interpret=route.interpret,
        )
    if q.shape[1] != nKV:
        # GQA: fold the query group into attend_chunk's query axis
        out = attend_chunk(cache, layer, q[:, None], valid[:, None, :], sm_scale)
        return out[:, 0]

    cache_l = _unpack_layer({
        k: jax.lax.dynamic_index_in_dim(v, layer, axis=0, keepdims=False)
        for k, v in cache.items()
    })
    k8 = cache_l["k"]
    kc = k8.astype(q.dtype) if quantized(cache_l) else k8
    scores = jnp.einsum(
        "bhd,bhsd->bhs", q, kc.astype(q.dtype), preferred_element_type=jnp.float32,
    )
    if quantized(cache_l):
        scores = scores * cache_l["k_s"].astype(jnp.float32)
    scores = scores * sm_scale
    scores = jnp.where(valid[:, None, :], scores, MASK_VALUE)
    probs = jax.nn.softmax(scores, axis=-1)
    if quantized(cache_l):
        pv = (probs * cache_l["v_s"].astype(jnp.float32)).astype(q.dtype)
    else:
        pv = probs.astype(cache_l["v"].dtype)
    out = jnp.einsum(
        "bhs,bhsd->bhd", pv, cache_l["v"].astype(pv.dtype),
        preferred_element_type=jnp.float32,
    )
    return out.astype(q.dtype)
