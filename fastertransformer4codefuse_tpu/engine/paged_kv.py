"""Paged KV cache: page-pool slabs + per-slot block tables.

The continuous batcher's dense mode reserves a CONTIGUOUS max_seq_len region
per slot ([L, B, nKV, S, dh] slabs), so pool HBM scales with the worst-case
length of every slot even when most requests are short — the weakness the
length-classed multi-pool serving only coarsely mitigates. Paged mode
(PagedAttention-style block tables) replaces the per-slot
regions with one shared page pool:

  - ``pk``/``pv``: [L, P, nKV, ps, dh] page-pool slabs (P pages of ps
    positions each, covering ALL layers per page id); ``pk_s``/``pv_s``
    per-vector scales [L, P, nKV, ps] when quantized.
  - ``pt``: [B, n_pg] int32 block table — slot b's logical positions
    [j*ps, (j+1)*ps) live in physical page ``pt[b, j]``.
  - page 0 is the GARBAGE page: never allocated, the write target for rows
    that must not disturb readable state (the paged analog of
    kv_cache.write_decode's "sacrifice_last" mode; every paged write is a
    per-row dynamic-update-slice, never a batched scatter).

Allocation is reservation-based: admission reserves ceil(stop_at/ps) pages
up front (PageAllocator), so a running request can never hit a mid-flight
out-of-pages condition and no eviction/recompute machinery is needed. HBM
now scales with the SUM of actual request lengths instead of
slots x max_seq_len.

The reference has no analog — its batches are static with per-batch
contiguous caches sized by the max sequence in the batch
(/root/reference/src/fastertransformer/models/gptneox/GptNeoX.cc:84-156).

On the GPU, decode attention over the paged pool rides
ops/flash_decode.flash_decode_paged (the block-table variant of the chunked
online-softmax kernel: each program reads its row's block table and walks its
pages only up to the row's length, so reads stay length-proportional).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp

from ..core.config import GptNeoXConfig

Cache = Dict[str, jax.Array]


def is_paged(cache: Cache) -> bool:
    return "pt" in cache


def packed4(cache: Cache, which: str) -> bool:
    """True when page slab ``which`` ("pk"/"pv") is stored nibble-packed."""
    return f"{which}4" in cache


def _slab(cache: Cache, which: str):
    return cache.get(which + "4", cache.get(which))


def page_size(cache: Cache) -> int:
    if quantized(cache):
        return cache["pk_s"].shape[3]  # scales always carry unpacked length
    return cache["pk"].shape[3]


def num_pages(cache: Cache) -> int:
    return _slab(cache, "pk").shape[1]


def logical_seq_len(cache: Cache) -> int:
    return cache["pt"].shape[1] * page_size(cache)


def quantized(cache: Cache) -> bool:
    return "pk_s" in cache


def init_paged_cache(
    config: GptNeoXConfig,
    num_slots: int,
    max_seq_len: int,
    n_pages: int,
    page_size: int = 256,
    dtype=jnp.bfloat16,
) -> Cache:
    """``dtype``: a jnp dtype, jnp.int8 (per-vector scales), or the strings
    "int4" / "int8k_int4v" — nibble-packed pages (adjacent SEQUENCE
    positions two-per-byte, the dense cache's pair order) quarter/halve
    the pool's KV bytes, i.e. 2-4x the pages per GB. Packed pages are safe
    where the dense pool's packed slabs are not: chunk starts are multiples
    of prompt_bucket (even), and decode writes read-modify-write the pair
    byte per row."""
    assert max_seq_len % page_size == 0
    n_pg = max_seq_len // page_size
    assert n_pages >= 2, "need at least the garbage page + one real page"
    shape = (
        config.layer_num,
        n_pages,
        config.kv_heads,
        page_size,
        config.size_per_head,
    )
    kind = dtype if isinstance(dtype, str) else None
    if kind is not None and kind not in ("int4", "int8k_int4v"):
        raise ValueError(
            f"unknown paged-cache dtype string {kind!r}: pass a jnp dtype "
            "(e.g. jnp.int8) or 'int4' / 'int8k_int4v'"
        )
    if kind in ("int4", "int8k_int4v"):
        assert page_size % 2 == 0
        pshape = shape[:3] + (page_size // 2, shape[4])
        c = {
            "pk_s": jnp.zeros(shape[:-1], jnp.bfloat16),
            "pv_s": jnp.zeros(shape[:-1], jnp.bfloat16),
            "pv4": jnp.zeros(pshape, jnp.int8),
        }
        if kind == "int4":
            c["pk4"] = jnp.zeros(pshape, jnp.int8)
        else:
            c["pk"] = jnp.zeros(shape, jnp.int8)
    elif dtype == jnp.int8:
        c = {
            "pk": jnp.zeros(shape, jnp.int8),
            "pv": jnp.zeros(shape, jnp.int8),
            "pk_s": jnp.zeros(shape[:-1], jnp.bfloat16),
            "pv_s": jnp.zeros(shape[:-1], jnp.bfloat16),
        }
    else:
        c = {"pk": jnp.zeros(shape, dtype), "pv": jnp.zeros(shape, dtype)}
    c["pt"] = jnp.zeros((num_slots, n_pg), jnp.int32)
    return c


class PageAllocator:
    """Host-side free list over page ids [1, P) (page 0 = garbage page)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, capacity: int, ps: int) -> int:
        return -(-capacity // ps)

    def can(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        assert self.can(n), f"allocator exhausted: want {n}, free {len(self._free)}"
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: List[int]) -> None:
        self._free.extend(pages)


# --------------------------------------------------------------- writes ----


def _quantize_vec(x, qmax: float = 127.0):
    from . import kv_cache as kvc

    return kvc._quantize_vec(x, qmax)


def write_decode_paged(
    cache: Cache, layer, k: jax.Array, v: jax.Array, positions: jax.Array,
    skip=None,
) -> Cache:
    """Write one token per row (k, v: [B, 1, nKV, dh]) at logical position
    ``positions[b]`` -> physical (page pt[b, pos//ps], offset pos%ps).
    ``skip`` rows write the garbage page instead (layout-neutral skip; see
    module docstring). Per-row unrolled dynamic-update-slices."""
    ps = page_size(cache)
    pt = cache["pt"]
    B = positions.shape[0]
    kt, vt = k[:, 0], v[:, 0]  # [B, nKV, dh]
    out = dict(cache)

    pages = pt[jnp.arange(B), positions // ps]
    if skip is not None:
        pages = jnp.where(skip, 0, pages)
    offs = positions % ps

    def w4(name, t):
        """Packed page write: read-modify-write the position-pair byte (even
        slots overwrite the whole byte, odd slots merge over the low nibble
        — the dense cache's nibble order)."""
        slab = out[name + "4"]
        q, s = _quantize_vec(t, 7.0)
        nKV, dh = slab.shape[2], slab.shape[4]
        for b in range(B):
            bo = offs[b] // 2
            old = jax.lax.dynamic_slice(
                slab, (layer, pages[b], 0, bo, 0), (1, 1, nKV, 1, dh)
            )
            qb = q[b][None, None, :, None, :]
            newb = jnp.where(
                offs[b] % 2 == 1,
                (old & 0x0F) | jnp.left_shift(qb, 4),
                qb & 0xF,
            )
            slab = jax.lax.dynamic_update_slice(
                slab, newb.astype(slab.dtype), (layer, pages[b], 0, bo, 0)
            )
        out[name + "4"] = slab
        _w(name + "_s", s)

    def _w(name, new):
        slab = out[name]
        for b in range(B):
            if slab.ndim == 4:  # scale slab [L, P, nKV, ps], new [B, nKV]
                upd = new[b][None, None, :, None]
                idx = (layer, pages[b], 0, offs[b])
            else:  # [L, P, nKV, ps, dh], new [B, nKV, dh]
                upd = new[b][None, None, :, None, :]
                idx = (layer, pages[b], 0, offs[b], 0)
            slab = jax.lax.dynamic_update_slice(slab, upd.astype(slab.dtype), idx)
        out[name] = slab

    if quantized(cache):
        for name, t in (("pk", kt), ("pv", vt)):
            if packed4(cache, name):
                w4(name, t)
            else:
                q, s = _quantize_vec(t)
                _w(name, q)
                _w(name + "_s", s)
    else:
        _w("pk", kt)
        _w("pv", vt)
    return out


def write_chunk_paged(
    cache: Cache, layer, k: jax.Array, v: jax.Array, pos: jax.Array,
    active: jax.Array,
) -> Cache:
    """Write a C-token chunk per row (k, v: [B, C, nKV, dh]) at per-row chunk
    starts ``pos`` (multiples of C). Requires ps % C == 0 so a chunk never
    straddles a page boundary; inactive rows write the garbage page."""
    ps = page_size(cache)
    pt = cache["pt"]
    B, C = k.shape[0], k.shape[1]
    assert ps % C == 0, (
        f"prompt_bucket ({C}) must divide page_size ({ps}) so chunk writes "
        "stay within one page"
    )
    kt = k.transpose(0, 2, 1, 3)  # [B, nKV, C, dh]
    vt = v.transpose(0, 2, 1, 3)
    out = dict(cache)

    pages = jnp.where(active, pt[jnp.arange(B), pos // ps], 0)
    offs = pos % ps

    def upd(name, new, half=False):
        slab = out[name]
        o = offs // 2 if half else offs
        for b in range(B):
            if slab.ndim == 4:  # scale slab, new [B, nKV, C]
                idx = (layer, pages[b], 0, o[b])
            else:  # new [B, nKV, C(/2), dh]
                idx = (layer, pages[b], 0, o[b], 0)
            slab = jax.lax.dynamic_update_slice(
                slab, new[b][None, None].astype(slab.dtype), idx
            )
        out[name] = slab

    if quantized(cache):
        from .kv_cache import _pack_seq_pairs

        for name, t in (("pk", kt), ("pv", vt)):
            if packed4(cache, name):
                assert C % 2 == 0, "packed pages need an even prompt_bucket"
                q, s = _quantize_vec(t, 7.0)
                upd(name + "4", _pack_seq_pairs(q), half=True)
                upd(name + "_s", s)
            else:
                q, s = _quantize_vec(t)
                upd(name, q)
                upd(name + "_s", s)
    else:
        upd("pk", kt)
        upd("pv", vt)
    return out


# ---------------------------------------------------------------- reads ----


def gather_layer_dense(cache: Cache, layer) -> Cache:
    """Materialize layer ``layer`` as a dense per-layer view
    {"k": [B, nKV, S, dh], ...} by gathering each slot's pages (the XLA
    attention paths and chunk-prefill attention; on the GPU the decode path
    reads the pages in place through the decode kernel instead). The gather
    indexes the LEADING page axis only, so the minor [ps, dh] layout is
    untouched."""
    from .kv_cache import _unpack_seq_pairs

    pt = cache["pt"]
    B, n_pg = pt.shape
    out = {}
    for name in ("pk", "pk4", "pv", "pv4", "pk_s", "pv_s"):
        if name not in cache:
            continue
        slab_l = jax.lax.dynamic_index_in_dim(
            cache[name], layer, axis=0, keepdims=False
        )  # [P, nKV, ps(/2)(, dh)]
        g = jnp.take(slab_l, pt.reshape(-1), axis=0)  # [B*n_pg, nKV, ...]
        g = g.reshape((B, n_pg) + slab_l.shape[1:])
        if g.ndim == 5:  # [B, n_pg, nKV, ps(/2), dh] -> [B, nKV, S, dh]
            g = g.transpose(0, 2, 1, 3, 4).reshape(
                B, g.shape[2], n_pg * g.shape[3], g.shape[4]
            )
            if name.endswith("4"):
                g = _unpack_seq_pairs(g, axis=-2)
            out[{"pk": "k", "pk4": "k", "pv": "v", "pv4": "v"}[name]] = g
        else:  # [B, n_pg, nKV, ps] -> [B, nKV, S]
            g = g.transpose(0, 2, 1, 3).reshape(B, g.shape[2], n_pg * g.shape[3])
            out[{"pk_s": "k_s", "pv_s": "v_s"}[name]] = g
    return out
