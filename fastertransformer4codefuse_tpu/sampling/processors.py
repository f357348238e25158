"""Batched, jit-safe logit processors and stop criteria.

A rebuild of the reference's DynamicDecodeLayer pipeline
(/root/reference/src/fastertransformer/layers/DynamicDecodeLayer.cc:192-497):
optional-last-tokens mask -> bad-words ban -> penalties -> sampling ->
stop-words criterion -> length criterion. Every processor takes per-sample
parameter arrays (no retracing for heterogeneous requests — the reference
instead iterates per-sample when args differ, DynamicDecodeLayer.cc:500+).

All processors work on fp32 logits ``[BB, V]`` where BB = batch*beam.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = float(jnp.finfo(jnp.float32).min)


def apply_temperature(logits: jax.Array, temperature: jax.Array) -> jax.Array:
    """logits / temperature, guarding temperature==0 (treated as 1).
    ≙ invokeBatchApplyTemperaturePenalty (sampling_penalty_kernels.cu)."""
    t = jnp.where(temperature <= 0.0, 1.0, temperature).astype(jnp.float32)
    return logits / t[:, None]


def apply_repetition_penalty(
    logits: jax.Array,  # [BB, V]
    token_buffer: jax.Array,  # [BB, T] all tokens so far (padded buffer)
    buffer_valid: jax.Array,  # [BB, T] bool — real (non-pad) positions before now
    penalty: jax.Array,  # [BB] multiplicative penalty (1.0 = off)
) -> jax.Array:
    """FT-style multiplicative repetition penalty: for every token id present in
    the sequence, logit>0 ? logit/p : logit*p.
    ≙ invokeBatchApplyRepetitionPenalty (sampling_penalty_kernels.cu), applied
    once per unique token id."""
    BB, V = logits.shape
    tok = jnp.where(buffer_valid, token_buffer, V)  # out-of-range drops below
    occurs = jnp.zeros((BB, V + 1), jnp.bool_)
    occurs = occurs.at[jnp.arange(BB)[:, None], tok].set(True)
    occurs = occurs[:, :V]
    p = penalty.astype(jnp.float32)[:, None]
    penalized = jnp.where(logits > 0, logits / p, logits * p)
    return jnp.where(occurs & (p != 1.0), penalized, logits)


def apply_presence_penalty(
    logits: jax.Array,
    token_buffer: jax.Array,
    buffer_valid: jax.Array,
    penalty: jax.Array,
) -> jax.Array:
    """Additive presence penalty (FT RepetitionPenaltyType::Additive)."""
    BB, V = logits.shape
    tok = jnp.where(buffer_valid, token_buffer, V)
    occurs = jnp.zeros((BB, V + 1), jnp.bool_)
    occurs = occurs.at[jnp.arange(BB)[:, None], tok].set(True)
    occurs = occurs[:, :V]
    return jnp.where(occurs, logits - penalty.astype(jnp.float32)[:, None], logits)


def apply_min_length(
    logits: jax.Array,
    gen_lengths: jax.Array,  # [BB] number of tokens generated so far
    min_length: jax.Array,  # [BB]
    end_id: int,
) -> jax.Array:
    """Mask end_id while generated length < min_length
    (≙ invokeMinLengthPenalty)."""
    mask = gen_lengths < min_length
    return logits.at[:, end_id].set(
        jnp.where(mask, NEG_INF, logits[:, end_id])
    )


def apply_optional_last_tokens(
    logits: jax.Array,  # [BB, V]
    optional_last_tokens: jax.Array,  # [B, max_count] int32, -1 padded
    beam_width: int,
    is_first_step: jax.Array,  # scalar bool
) -> jax.Array:
    """At the first generated step only, allow just the listed token ids.

    ≙ the fork's select_optional_last_tokens kernel
    (/root/reference/src/fastertransformer/kernels/select_optional_last_tokens.cu:21-117)
    gated at DynamicDecodeLayer.cc:250-267. A batch row whose list is all -1
    (no constraint) is left untouched.
    """
    B, C = optional_last_tokens.shape
    BB, V = logits.shape
    assert BB == B * beam_width
    tok = jnp.where(optional_last_tokens >= 0, optional_last_tokens, V)
    allowed = jnp.zeros((B, V + 1), jnp.bool_)
    allowed = allowed.at[jnp.arange(B)[:, None], tok].set(True)
    allowed = allowed[:, :V]
    has_constraint = jnp.any(optional_last_tokens >= 0, axis=1)  # [B]
    allowed = jnp.where(has_constraint[:, None], allowed, True)
    allowed = jnp.repeat(allowed, beam_width, axis=0)  # [BB, V]
    masked = jnp.where(allowed, logits, NEG_INF)
    return jnp.where(is_first_step, masked, logits)


def _match_word_endings(
    token_buffer: jax.Array,  # [BB, T]
    cur_end: jax.Array,  # [BB] — exclusive end: position after the last token
    words: jax.Array,  # [B, 2, L] flat ids + cumulative offsets (-1 padded)
    beam_width: int,
) -> jax.Array:
    """True per row iff the buffer ends (at cur_end) with any listed word.

    Word w occupies flat[start:end) where end = offsets[wi] and start =
    offsets[wi-1] (0 for wi=0). Matching follows the reference's
    invokeStopWordsCriterion (stop_criteria_kernels.cu): compare the last
    ``len(w)`` absolute buffer positions.
    """
    B, _, L = words.shape
    BB, T = token_buffer.shape
    flat = jnp.repeat(words[:, 0, :], beam_width, axis=0)  # [BB, L]
    offs = jnp.repeat(words[:, 1, :], beam_width, axis=0)  # [BB, L]

    j = jnp.arange(L)[None, :]  # word-buffer column index

    def match_one(wi):
        end = offs[:, wi]  # [BB] cumulative end (or -1 pad)
        start = jnp.where(wi > 0, offs[:, wi - 1], 0)
        start = jnp.where(start < 0, 0, start)
        lw = end - start
        word_ok = (end > 0) & (lw > 0) & (lw <= cur_end)
        # buffer index aligned so flat[:, end-1] lines up with buffer[:, cur_end-1]
        tgt = cur_end[:, None] - (end[:, None] - j)  # [BB, L]
        tgt_clip = jnp.clip(tgt, 0, T - 1)
        buf_tok = jnp.take_along_axis(token_buffer, tgt_clip, axis=1)
        in_word = (j >= start[:, None]) & (j < end[:, None])
        ok = jnp.where(in_word, (buf_tok == flat) & (tgt >= 0), True)
        return jnp.all(ok, axis=1) & word_ok  # [BB]

    matches = jax.vmap(match_one)(jnp.arange(L))  # [L, BB]
    return jnp.any(matches, axis=0)


def stop_words_criterion(
    token_buffer: jax.Array,  # [BB, T]
    cur_end: jax.Array,  # [BB] exclusive end position (after newest token)
    stop_words: jax.Array,  # [B, 2, L]
    beam_width: int,
) -> jax.Array:
    """[BB] bool: sequence just hit a stop word."""
    return _match_word_endings(token_buffer, cur_end, stop_words, beam_width)


def ban_bad_words(
    logits: jax.Array,  # [BB, V]
    token_buffer: jax.Array,  # [BB, T]
    cur_end: jax.Array,  # [BB] exclusive end of generated-so-far
    bad_words: jax.Array,  # [B, 2, L]
    beam_width: int,
) -> jax.Array:
    """Ban a bad word's final token when the buffer ends with its prefix.
    ≙ invokeBanBadWords (ban_bad_words.cu). Single-token bad words are always
    banned."""
    B, _, L = bad_words.shape
    BB, V = logits.shape
    flat = jnp.repeat(bad_words[:, 0, :], beam_width, axis=0)
    offs = jnp.repeat(bad_words[:, 1, :], beam_width, axis=0)
    T = token_buffer.shape[1]
    j = jnp.arange(L)[None, :]

    def one(wi):
        end = offs[:, wi]
        start = jnp.where(wi > 0, offs[:, wi - 1], 0)
        start = jnp.where(start < 0, 0, start)
        lw = end - start
        prefix_len = lw - 1
        word_ok = (end > 0) & (lw > 0) & (prefix_len <= cur_end)
        # prefix occupies flat[start:end-1]; align its END with cur_end
        tgt = cur_end[:, None] - ((end[:, None] - 1) - j)
        tgt_clip = jnp.clip(tgt, 0, T - 1)
        buf_tok = jnp.take_along_axis(token_buffer, tgt_clip, axis=1)
        in_prefix = (j >= start[:, None]) & (j < (end[:, None] - 1))
        ok = jnp.where(in_prefix, (buf_tok == flat) & (tgt >= 0), True)
        matched = jnp.all(ok, axis=1) & word_ok  # [BB]
        last_tok = jnp.take_along_axis(
            flat, jnp.clip(end - 1, 0, L - 1)[:, None], axis=1
        )[:, 0]
        return matched, last_tok

    matched, last_tok = jax.vmap(one, out_axes=(0, 0))(jnp.arange(L))  # [L, BB]
    ban_tok = jnp.where(matched, last_tok, V).T  # [BB, L]
    banned = jnp.zeros((BB, V + 1), jnp.bool_)
    banned = banned.at[jnp.arange(BB)[:, None], ban_tok].set(True)
    return jnp.where(banned[:, :V], NEG_INF, logits)
