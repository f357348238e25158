"""Attention paths: prefill and single-token decode.

These replace, respectively:
  - the reference's TRT fused flash MHA / unfused bmm+softmax prefill path
    (/root/reference/src/fastertransformer/layers/attention_layers/
     GptContextAttentionLayer.cc:195-310), and
  - the fused masked multi-head decode kernel
    (/root/reference/src/fastertransformer/kernels/
     decoder_masked_multihead_attention.cu).

The einsum forms here are the numerically-canonical implementations; the
library route for prefill (cuDNN's fused attention through
``jax.nn.dot_product_attention``) and the decode kernel in ``flash_decode.py``
must match them. Softmax statistics in fp32, scores masked with a large
negative value (not -inf, to avoid NaN on fully-masked rows).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import routes

MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)

def fused_prefill_ok(q: jax.Array) -> bool:
    """Shapes and dtypes cuDNN's fused attention takes: 16-bit operands and
    a head dim that is a multiple of 8, at most 128."""
    dh = q.shape[-1]
    return q.dtype in (jnp.bfloat16, jnp.float16) and dh % 8 == 0 and dh <= 128


def prefill_attention_fused(
    q: jax.Array,  # [B, S, nH, dh]
    k: jax.Array,  # [B, S, nKV, dh]
    v: jax.Array,
    input_lengths: jax.Array,  # [B]
    sm_scale: float,
    implementation: str = "cudnn",
) -> jax.Array:
    """Causal, right-padded prefill through ``jax.nn.dot_product_attention``
    (cuDNN's fused flash attention on the GPU — the library analog of the
    reference's TRT fused MHA cubins, 3rdparty/trt_fused_multihead_attention/).
    Padding is given as per-row lengths; rows past a row's length are zeroed,
    so their (never read) outputs stay finite for the layers above."""
    S = q.shape[1]
    out = jax.nn.dot_product_attention(
        q, k, v, scale=sm_scale, is_causal=True,
        query_seq_lengths=input_lengths, key_value_seq_lengths=input_lengths,
        implementation=implementation,
    )
    live = jnp.arange(S)[None, :, None, None] < input_lengths[:, None, None, None]
    return jnp.where(live, out, 0).astype(q.dtype)


def prefill_attention(
    q: jax.Array,  # [B, S, nH, dh]
    k: jax.Array,  # [B, S, nKV, dh] (nKV < nH under GQA)
    v: jax.Array,  # [B, S, nKV, dh]
    mask: jax.Array,  # [B, S, S] bool, True = may attend (causal & padding)
    sm_scale: float,
    input_lengths=None,  # enables the fused path when set and shapes allow
) -> jax.Array:
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    if (
        routes.current().flash_prefill
        and input_lengths is not None
        and fused_prefill_ok(q)
    ):
        return prefill_attention_fused(q, k, v, input_lengths, sm_scale)
    if nKV != nH:
        # GQA: group the g query heads sharing each KV head — the KV tensors
        # are contracted per group WITHOUT materializing a repeated copy
        g = nH // nKV
        qg = q.reshape(B, S, nKV, g, dh)
        scores = jnp.einsum(
            "bqhgd,bkhd->bhgqk", qg, k, preferred_element_type=jnp.float32
        )
        scores = scores * sm_scale
        scores = jnp.where(mask[:, None, None, :, :], scores, MASK_VALUE)
        probs = jax.nn.softmax(scores, axis=-1)
        out = jnp.einsum(
            "bhgqk,bkhd->bqhgd", probs.astype(v.dtype), v,
            preferred_element_type=jnp.float32,
        )
        return out.reshape(B, S, nH, dh).astype(q.dtype)
    scores = jnp.einsum(
        "bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32
    )
    scores = scores * sm_scale
    scores = jnp.where(mask[:, None, :, :], scores, MASK_VALUE)
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum(
        "bhqk,bkhd->bqhd", probs.astype(v.dtype), v, preferred_element_type=jnp.float32
    )
    return out.astype(q.dtype)


def decode_attention(
    q: jax.Array,  # [B, nH, dh] — one new token per sequence
    k_cache: jax.Array,  # [B, nH, S, dh]
    v_cache: jax.Array,  # [B, nH, S, dh]
    valid: jax.Array,  # [B, S] bool, True = cache slot participates
    sm_scale: float,
) -> jax.Array:
    scores = jnp.einsum(
        "bhd,bhsd->bhs", q, k_cache, preferred_element_type=jnp.float32
    )
    scores = scores * sm_scale
    scores = jnp.where(valid[:, None, :], scores, MASK_VALUE)
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum(
        "bhs,bhsd->bhd", probs.astype(v_cache.dtype), v_cache,
        preferred_element_type=jnp.float32,
    )
    return out.astype(q.dtype)


def make_prefill_mask(input_lengths: jax.Array, seq_len: int) -> jax.Array:
    """Causal & right-padding mask, the analog of invokeBuildDecoderAttentionMask
    (/root/reference/src/fastertransformer/kernels/gpt_kernels.cu).

    Token i may attend token j iff j <= i and j < input_length.
    Returns [B, S, S] bool.
    """
    pos = jnp.arange(seq_len)
    causal = pos[None, :, None] >= pos[None, None, :]  # [1, S, S]
    in_len = pos[None, None, :] < input_lengths[:, None, None]  # [B, 1, S]
    return jnp.logical_and(causal, in_len)


def make_decode_valid(positions: jax.Array, cache_len: int) -> jax.Array:
    """Valid-slot mask for decode: slot j participates iff j <= position[b].

    Unlike the reference, which right-pads ragged batches and carries dead cache
    slots masked via ``masked_tokens`` (GptNeoX.cc decode loop), this engine
    packs each sequence contiguously (new token b goes to slot positions[b]), so
    validity is a single comparison. Returns [B, cache_len] bool; the new
    token's own slot is valid because its K/V are written before attention.
    """
    pos = jnp.arange(cache_len)[None, :]
    return pos <= positions[:, None]
