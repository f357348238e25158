"""Decode attention over the KV cache as a Pallas kernel for the GPU (Triton).

The analog of the reference's fused masked multi-head attention decode kernel
(/root/reference/src/fastertransformer/kernels/decoder_masked_multihead_attention.cu:
one block per (batch, head) walking the cached keys up to the current length).

- One program per (row, KV head, sequence split). It loads its row's newest
  position (and, for a paged pool, its block-table entries) itself and loops
  over the cache in chunks of ``bk`` positions up to that position, so only
  live cache bytes are read. The XLA path reads the whole allocated slab
  (engine/kv_cache.attend_decode) or first gathers every page into a dense
  copy (engine/paged_kv.gather_layer_dense).
- Splits along the sequence keep the card busy at batch 1: each split keeps
  its own online softmax in float32 registers and writes a partial
  (numerator, max, denominator); the wrapper combines the splits
  (flash-decoding). A split that lies wholly past the row's position does no
  work.
- Int8 caches are dequantised in registers with their per-vector scales;
  they are read as int16 words (two head-dim lanes each, see ``_words``).
  Nibble-packed int4 slabs (two sequence positions per byte) are read once
  and split into their even and odd positions.
- The layer index is a kernel operand, so the kernel reads straight out of
  the stacked ``[L, ...]`` cache that the layer scan carries, with no
  per-layer slice copy.
- The products are plain broadcast-multiply-reduce over ``dh``: decode
  attention is bound by cache bytes, and each query row (one per query head
  of the KV head's group) is its own dot product.

The XLA paths in engine/kv_cache.py are the reference the kernel is tested
against (``interpret=True`` on the CPU).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)

# Programs to aim for: two per SM of an H100 (132 SMs), so that a decode step
# at batch 1 still spreads its cache reads over the whole card.
_TARGET_PROGRAMS = 264
_MIN_CHUNK = 16


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two that divides ``n`` and is at most ``cap``."""
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def supported(seq_len: int, head_dim: int, page_size: int = 0) -> bool:
    """Shapes the kernel takes: a power-of-two head dim, and chunks of at
    least ``_MIN_CHUNK`` positions that tile the slab (or the page)."""
    if head_dim & (head_dim - 1):
        return False
    n = page_size or seq_len
    return _pow2_divisor(n, _MIN_CHUNK) == _MIN_CHUNK


def _bits(w, lo: int, width: int):
    """Sign-extended ``width``-bit field at bit ``lo`` of int16 words, as
    float32."""
    w = w.astype(jnp.int32)
    return ((w << (32 - lo - width)) >> (32 - width)).astype(jnp.float32)


def _kernel(
    layer_ref, pos_ref, pt_ref, q_ref, k_ref, ks_ref, v_ref, vs_ref,
    o_ref, m_ref, l_ref, *, g, sm_scale, bk, ps, chunks_per_split,
    k_packed, v_packed, lanes,
):
    b = pl.program_id(0)
    h = pl.program_id(1)
    sp = pl.program_id(2)
    layer = layer_ref[0]
    pos = pos_ref[b]
    dh = q_ref.shape[-1]
    w = dh // lanes  # words per cached vector
    # int8 slabs arrive as int16 words (two head-dim lanes per word, see
    # _decode): lane jl of a word holds element jl + lanes * i of the vector
    qs = [
        [q_ref[r, pl.ds(jl, w, lanes)].astype(jnp.float32) * sm_scale
         for jl in range(lanes)]
        for r in range(g)
    ]
    # an int4 slab holds positions (2i, 2i+1) in one byte: a chunk is then
    # processed as its even and its odd positions
    halves = 2 if (k_packed or v_packed) else 1
    n = bk // halves

    def locate(c):
        """(second slab index, offset) of logical chunk ``c``."""
        start = c * bk
        if pt_ref is None:
            return b, start
        return pt_ref[b, start // ps], start % ps

    def load(ref, sref, packed, idx, off, j):
        """Values [lanes x (n, w)] and scales (n,) of half ``j`` of a chunk."""
        if packed:
            words = ref[layer, idx, h, pl.ds(off // 2, n), :]
            vals = [_bits(words, 8 * jl + 4 * j, 4) for jl in range(lanes)]
        else:
            rows = pl.ds(off + j, n, halves)
            words = ref[layer, idx, h, rows, :]
            if lanes == 1:
                vals = [words.astype(jnp.float32)]
            else:
                vals = [_bits(words, 8 * jl, 8) for jl in range(lanes)]
        scale = None
        if sref is not None:
            scale = sref[layer, idx, h, pl.ds(off + j, n, halves)]
            scale = scale.astype(jnp.float32)
        return vals, scale

    def body(c, carry):
        accs, ms, ls = carry
        accs = [list(a) for a in accs]
        ms, ls = list(ms), list(ls)
        idx, off = locate(c)
        for j in range(halves):
            kf, ksc = load(k_ref, ks_ref, k_packed, idx, off, j)
            vf, vsc = load(v_ref, vs_ref, v_packed, idx, off, j)
            valid = c * bk + j + halves * jnp.arange(n) <= pos  # [n]
            # stale tail bytes may hold NaN: 0 * NaN would poison the sum
            vf = [jnp.where(valid[:, None], x, 0.0) for x in vf]
            for r in range(g):
                s = sum(
                    jnp.sum(kf[jl] * qs[r][jl][None, :], axis=1)
                    for jl in range(lanes)
                )  # [n]
                if ksc is not None:
                    s = s * ksc
                s = jnp.where(valid, s, MASK_VALUE)
                m_new = jnp.maximum(ms[r], jnp.max(s))
                alpha = jnp.exp(ms[r] - m_new)
                p = jnp.where(valid, jnp.exp(s - m_new), 0.0)
                ls[r] = alpha * ls[r] + jnp.sum(p)
                pw = p if vsc is None else p * vsc
                for jl in range(lanes):
                    accs[r][jl] = alpha * accs[r][jl] + jnp.sum(
                        pw[:, None] * vf[jl], axis=0
                    )
                ms[r] = m_new
        return tuple(tuple(a) for a in accs), tuple(ms), tuple(ls)

    init = (
        tuple(tuple(jnp.zeros((w,), jnp.float32) for _ in range(lanes))
              for _ in range(g)),
        tuple(jnp.float32(MASK_VALUE) for _ in range(g)),
        tuple(jnp.float32(0.0) for _ in range(g)),
    )
    lo = sp * chunks_per_split
    hi = jnp.minimum(lo + chunks_per_split, pos // bk + 1)
    accs, ms, ls = lax.fori_loop(lo, hi, body, init)
    for r in range(g):
        for jl in range(lanes):
            o_ref[r, pl.ds(jl, w, lanes)] = accs[r][jl]
        m_ref[r] = ms[r]
        l_ref[r] = ls[r]


def _words(x):
    """An int8 slab [..., dh] viewed as int16 words [..., dh/2] (a bitcast).

    The Triton lowering computes element offsets in 32 bits for arrays of at
    most 2**32 bytes, so an int8 slab between 2 and 4 GiB — a 13B KV pool —
    would overflow them; as int16 words the element count halves."""
    return jax.lax.bitcast_convert_type(
        x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)), jnp.int16
    )


def _decode(
    q, k, ks, v, vs, layer, positions, page_table, *, sm_scale, seq_len, ps, bk,
    k_packed, v_packed, interpret, num_warps, num_stages,
):
    B, nH, dh = q.shape
    nKV = k.shape[2]
    assert nH % nKV == 0
    g = nH // nKV
    lanes = 2 if k.dtype == jnp.int8 else 1
    assert (v.dtype == jnp.int8) == (lanes == 2), "K and V slabs: both int8 or both float"
    if lanes == 2:
        k, v = _words(k), _words(v)
    n_chunks = seq_len // bk
    n_split = max(1, min(n_chunks, -(-_TARGET_PROGRAMS // (B * nKV))))
    per_split = -(-n_chunks // n_split)
    n_split = -(-n_chunks // per_split)
    whole = pl.no_block_spec  # the kernel indexes these itself
    operands = [
        jnp.asarray(layer, jnp.int32).reshape(1),
        positions.astype(jnp.int32),
        None if page_table is None else page_table.astype(jnp.int32),
        q.reshape(B, nKV, g, dh),
        k, ks, v, vs,
    ]
    in_specs = [
        whole, whole, None if page_table is None else whole,
        pl.BlockSpec((None, None, g, dh), lambda b, h, s: (b, h, 0, 0)),
        whole, None if ks is None else whole,
        whole, None if vs is None else whole,
    ]
    part = (B, nKV, n_split, g)
    o, m, l = pl.pallas_call(
        functools.partial(
            _kernel, g=g, sm_scale=sm_scale, bk=bk, ps=ps,
            chunks_per_split=per_split, k_packed=k_packed, v_packed=v_packed,
            lanes=lanes,
        ),
        grid=(B, nKV, n_split),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, g, dh), lambda b, h, s: (b, h, s, 0, 0)),
            pl.BlockSpec((None, None, None, g), lambda b, h, s: (b, h, s, 0)),
            pl.BlockSpec((None, None, None, g), lambda b, h, s: (b, h, s, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct(part + (dh,), jnp.float32),
            jax.ShapeDtypeStruct(part, jnp.float32),
            jax.ShapeDtypeStruct(part, jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="ftcf_decode_attention",
    )(*operands)
    # combine the splits (a split with no work has m = MASK_VALUE, l = 0)
    mx = jnp.max(m, axis=2, keepdims=True)
    w = jnp.exp(m - mx)
    num = jnp.sum(o * w[..., None], axis=2)
    den = jnp.maximum(jnp.sum(l * w, axis=2), 1e-20)
    return (num / den[..., None]).reshape(B, nH, dh).astype(q.dtype)


_STATIC = ("sm_scale", "bs", "interpret", "num_warps", "num_stages")


@functools.partial(jax.jit, static_argnames=_STATIC)
def flash_decode_stacked(
    q: jax.Array,  # [B, nH, dh] (nH may exceed the cache's KV heads: GQA)
    k_all: jax.Array,  # [L, B, nKV, S(/2), dh] int8 or float
    ks_all,  # [L, B, nKV, S] scales, or None for float caches
    v_all: jax.Array,
    vs_all,
    layer: jax.Array,  # scalar
    positions: jax.Array,  # [B] newest-token slot per row (inclusive bound)
    sm_scale: float,
    bs: int = 64,  # positions per chunk (the largest power of two <= bs dividing S)
    interpret: bool = False,
    num_warps: int = 4,
    num_stages: int = 2,
) -> jax.Array:
    """Decode attention over the dense stacked cache (engine/kv_cache.py)."""
    S = ks_all.shape[3] if ks_all is not None else k_all.shape[3]
    bk = _pow2_divisor(S, bs)
    return _decode(
        q, k_all, ks_all, v_all, vs_all, layer, positions, None,
        sm_scale=sm_scale, seq_len=S, ps=0, bk=bk,
        k_packed=k_all.shape[3] * 2 == S, v_packed=v_all.shape[3] * 2 == S,
        interpret=interpret, num_warps=num_warps, num_stages=num_stages,
    )


@functools.partial(jax.jit, static_argnames=_STATIC)
def flash_decode_paged(
    q: jax.Array,  # [B, nH, dh]
    pk: jax.Array,  # [L, P, nKV, ps(/2), dh] int8 or float page pool
    pks,  # [L, P, nKV, ps] scales, or None for float pages
    pv: jax.Array,
    pvs,
    layer: jax.Array,  # scalar
    positions: jax.Array,  # [B] newest-token LOGICAL slot (inclusive bound)
    page_table: jax.Array,  # [B, n_pg] physical page of each logical page
    sm_scale: float,
    bs: int = 64,
    interpret: bool = False,
    num_warps: int = 4,
    num_stages: int = 2,
) -> jax.Array:
    """Block-table decode attention over the paged pool (engine/paged_kv.py):
    chunk ``c`` of a row lives in page ``page_table[b, c*bk // ps]``."""
    ps = pks.shape[3] if pks is not None else pk.shape[3]
    bk = _pow2_divisor(ps, bs)
    return _decode(
        q, pk, pks, pv, pvs, layer, positions, page_table,
        sm_scale=sm_scale, seq_len=page_table.shape[1] * ps, ps=ps, bk=bk,
        k_packed=pk.shape[3] * 2 == ps, v_packed=pv.shape[3] * 2 == ps,
        interpret=interpret, num_warps=num_warps, num_stages=num_stages,
    )
