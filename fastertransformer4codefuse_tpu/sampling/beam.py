"""Beam search decoding.

Rebuild of the reference's beam stack
(/root/reference/src/fastertransformer/layers/beam_search_layers/
OnlineBeamSearchLayer.cu + BaseBeamSearchLayer.cu and the
online_softmax_beamsearch kernels): per-beam top-k -> diversity penalty ->
cross-beam merge, GNMT-style length penalty, finished beams frozen as
candidates, stop-words/end-id criteria per beam.

Like the reference, the KV cache stays FIXED and beam reassignments ride a
``cache_indirection`` table resolved inside decode attention
(GptNeoX.cc:776-778, 1011-1017; here engine.kv_cache.attend_decode_beam's
group-blocked all-pairs + one-hot select). Only the small host-side buffers
(tokens, lengths, scores) are physically reordered per step; sequences come
out packed, so no gather_tree reconstruction is needed.

Prompts are tiled beam_width times before prefill, exactly like the
reference's invokeTileGptInputs (GptNeoX.cc:590-597).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..sampling import processors as proc

NEG_INF = proc.NEG_INF


def _length_penalty_factor(lengths: jax.Array, len_penalty: jax.Array) -> jax.Array:
    """GNMT length normalization ((5+len)/6)^alpha (FT's apply_length_penalty)."""
    base = (5.0 + lengths.astype(jnp.float32)) / 6.0
    return jnp.power(base, len_penalty.astype(jnp.float32))


def beam_search_generate(
    engine,
    input_ids,
    output_len: int,
    beam_width: int,
    callback=None,
    beam_search_diversity_rate=None,
    len_penalty=None,
    **sampling_kwargs,
):
    from ..engine.engine import GenerationOutput
    from ..models import gptneox as model

    B = len(input_ids)
    bw = beam_width
    cfg = engine.config
    end_id = cfg.end_id

    # tile prompts beam-minor: rows [b*bw + j]
    tiled = [list(ids) for ids in input_ids for _ in range(bw)]
    # beam search ignores top_k/top_p (like the reference's DynamicDecodeLayer
    # routing, which dispatches to beam layers when beam_width > 1); beam
    # scoring needs per-token log-probs regardless, so return_cum_log_probs
    # is accepted-and-always-on here (the cum buffer is the beam score)
    sampling_kwargs.pop("top_k", None)
    sampling_kwargs.pop("top_p", None)
    sampling_kwargs.pop("return_cum_log_probs", None)
    # tile per-batch request arrays to per-row (beam-minor)
    for k, v in list(sampling_kwargs.items()):
        if v is None or np.isscalar(v):
            continue
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.shape[0] == B:
            sampling_kwargs[k] = np.repeat(arr, bw, axis=0)
    st, inputs = engine._prepare(tiled, output_len, **sampling_kwargs)

    def tile_param(v, default):
        if v is None:
            arr = np.full((B,), default, np.float32)
        elif np.isscalar(v):
            arr = np.full((B,), v, np.float32)
        else:
            arr = np.asarray(v, np.float32)
        return jnp.asarray(np.repeat(arr, bw))

    inputs = dict(inputs)
    inputs["diversity_rate"] = tile_param(beam_search_diversity_rate, 0.0)
    inputs["len_penalty"] = tile_param(len_penalty, 0.0)

    key = (st, bw, callback is not None)
    if not hasattr(engine, "_beam_cache"):
        engine._beam_cache = {}
    fn = engine._beam_cache.get(key)
    if fn is None:
        fn = _build_beam_fn(engine, st, bw, stepwise=callback is not None)
        engine._beam_cache[key] = fn

    if callback is None:
        tokens, seq_lens, cum_lp, step_lp = jax.device_get(
            fn(engine.params, inputs)
        )
    else:
        # stepwise streaming: the callback receives every beam's newest token
        # per step ({last_tokens: [[tok]*bw]*B, idxs: ...}), like the
        # reference's per-step pybind callback with beam_width > 1
        prefill_fn, step_fn, final_fn, finish_fn = fn
        s = prefill_fn(engine.params, inputs)
        in_lens = np.asarray(inputs["input_lengths"]).reshape(B, bw)
        for i in range(st.output_len):
            s = (final_fn if i == st.output_len - 1 else step_fn)(
                engine.params, inputs, s
            )
            newest, lens_d, fin = jax.device_get((s.newest, s.seq_lens, s.finished))
            # idxs = generated-region index of the newest token
            # (seq_idx - input_length, pybind_callback_utils.cc:88)
            callback(
                {
                    "last_tokens": newest.reshape(B, bw).tolist(),
                    "idxs": (lens_d.reshape(B, bw) - in_lens - 1).tolist(),
                }
            )
            if fin.all():
                break
        tokens, seq_lens, cum_lp, step_lp = jax.device_get(finish_fn(inputs, s))

    return GenerationOutput(
        output_ids=tokens.reshape(B, bw, -1),
        sequence_lengths=seq_lens.reshape(B, bw),
        cum_log_probs=cum_lp.reshape(B, bw),
        output_log_probs=(
            None if step_lp is None else step_lp.reshape(B, bw, -1)
        ),
    )


def _build_beam_fn(engine, st, bw: int, stepwise: bool = False):
    cfg = engine.config
    end_id = cfg.end_id
    B = st.batch // bw

    def process_logits(params, inputs, s):
        """Shared logit processors (same order as the sampling path /
        BaseBeamSearchLayer::invokeAddBiasApplyPenalties)."""
        logits = s.logits
        T = s.tokens.shape[1]
        if st.use_optional_last:
            # optional_last_tokens was prepared per tiled row -> beam grouping 1
            logits = proc.apply_optional_last_tokens(
                logits, inputs["optional_last_tokens"], 1, s.gen_step == 0
            )
        if st.use_bad_words:
            logits = proc.ban_bad_words(logits, s.tokens, s.seq_lens, inputs["bad_words"], 1)
        if st.use_temperature:
            logits = proc.apply_temperature(logits, inputs["temperature"])
        if st.use_rep_penalty:
            buf_valid = jnp.arange(T)[None, :] < s.seq_lens[:, None]
            logits = proc.apply_repetition_penalty(
                logits, s.tokens, buf_valid, inputs["repetition_penalty"]
            )
        if st.use_min_length:
            gen_lens = s.seq_lens - inputs["input_lengths"]
            logits = proc.apply_min_length(logits, gen_lens, inputs["min_length"], end_id)
        return logits

    def beam_advance(params, inputs, s):
        BB, T = s.tokens.shape
        V = cfg.vocab_size
        logits = process_logits(params, inputs, s)
        log_probs = jax.nn.log_softmax(logits, axis=-1)

        # finished beams contribute a single frozen candidate: end_id at lp 0
        finished_row = jnp.full((V,), NEG_INF, jnp.float32).at[end_id].set(0.0)
        log_probs = jnp.where(s.finished[:, None], finished_row[None, :], log_probs)

        # per-beam top-bw candidates
        top_lp, top_id = jax.lax.top_k(log_probs, bw)  # [BB, bw]
        cand_cum = s.cum_log_probs[:, None] + top_lp  # raw cumulative
        # diversity penalty on sibling rank (FT diversity_rate semantics)
        rank = jnp.arange(bw, dtype=jnp.float32)[None, :]
        cand_score = cand_cum - inputs["diversity_rate"][:, None] * rank
        # GNMT length penalty on the ranking score only
        new_lens = jnp.where(s.finished, s.seq_lens, s.seq_lens + 1)
        lp_factor = _length_penalty_factor(
            new_lens - inputs["input_lengths"], inputs["len_penalty"]
        )
        cand_score = cand_score / lp_factor[:, None]

        # cross-beam merge per batch
        cand_score = cand_score.reshape(B, bw * bw)
        cand_cum = cand_cum.reshape(B, bw * bw)
        cand_id = top_id.reshape(B, bw * bw)
        sel_score, sel = jax.lax.top_k(cand_score, bw)  # [B, bw]
        parent = sel // bw  # source beam within the batch
        new_tok = jnp.take_along_axis(cand_id, sel, axis=1)  # [B, bw]
        new_cum = jnp.take_along_axis(cand_cum, sel, axis=1)

        # global row indices for the reorder gather
        src = (jnp.arange(B)[:, None] * bw + parent).reshape(-1)  # [BB]
        new_tok = new_tok.reshape(-1)
        new_cum = new_cum.reshape(-1)

        tokens = jnp.take(s.tokens, src, axis=0)
        seq_lens = jnp.take(s.seq_lens, src, axis=0)
        finished = jnp.take(s.finished, src, axis=0)
        input_lengths = inputs["input_lengths"]  # identical across beams per batch

        # the KV cache stays FIXED; beam reassignment is tracked through the
        # indirection table instead (the reference's cache_indirection scheme,
        # GptNeoX.cc:1011-1017) — the [BB, S] int32 gather here replaces the
        # multi-GB [L, BB, nH, S, dh] cache gather per step
        indir = jnp.take(s.beam_indir, src, axis=0)

        tok = jnp.where(finished, end_id, new_tok)
        write_idx = jnp.clip(seq_lens, 0, T - 1)
        tokens = tokens.at[jnp.arange(BB), write_idx].set(
            jnp.where(finished, tokens[jnp.arange(BB), write_idx], tok)
        )
        # the next forward writes row b's new KV into row b itself at the CACHE
        # slot = buffer index + the row's prompt-prefix offset (prompt slots
        # [0, P) are never re-pointed: every beam shares the row's prompt KV)
        own = (jnp.arange(BB, dtype=jnp.int32) % bw)
        cache_idx = write_idx
        if st.prompt_width:
            cache_idx = write_idx + inputs["prompt_lengths"].astype(write_idx.dtype)
        indir = indir.at[jnp.arange(BB), cache_idx].set(
            jnp.where(finished, indir[jnp.arange(BB), cache_idx], own)
        )
        seq_lens = seq_lens + jnp.where(finished, 0, 1)
        cum_log_probs = jnp.where(finished, s.cum_log_probs[src], new_cum)

        newly = tok == end_id
        if st.use_stop_words:
            newly = newly | proc.stop_words_criterion(
                tokens, seq_lens, inputs["stop_words"], 1
            )
        finished = finished | newly

        step_log_probs = s.step_log_probs
        if st.use_output_log_probs:
            # the buffer follows the hypothesis' reorder path (like tokens), so
            # each returned beam's per-step values sum to its cum_log_prob
            inc = jnp.where(
                s.finished[src], 0.0, new_cum - s.cum_log_probs[src]
            )
            step_log_probs = jax.lax.dynamic_update_index_in_dim(
                jnp.take(step_log_probs, src, axis=0), inc, s.gen_step, axis=1
            )

        return s._replace(
            tokens=tokens,
            seq_lens=seq_lens,
            gen_step=s.gen_step + 1,
            finished=finished,
            cum_log_probs=cum_log_probs,
            beam_indir=indir,
            newest=tok,
            step_log_probs=step_log_probs,
        )

    def beam_prefill(params, inputs):
        s = engine._prefill_state(st, params, inputs)
        # step 0: only beam 0 of each batch proposes (classic init trick —
        # otherwise all beams pick identical tokens)
        beam_idx = jnp.arange(st.batch) % bw
        # each row's prompt KV was written by its own row (prompts tiled);
        # the table spans the FULL cache incl. the prompt slots [0, P)
        indir = jnp.broadcast_to(
            beam_idx.astype(jnp.int32)[:, None],
            (st.batch, st.total_len + st.prompt_width),
        )
        return s._replace(
            cum_log_probs=jnp.where(beam_idx == 0, 0.0, NEG_INF).astype(jnp.float32),
            beam_indir=indir,
        )

    def sort_outputs(inputs, s):
        # sort beams per batch by length-penalized score, best first
        lp_factor = _length_penalty_factor(
            s.seq_lens - inputs["input_lengths"], inputs["len_penalty"]
        )
        score = (s.cum_log_probs / lp_factor).reshape(B, bw)
        order = jnp.argsort(-score, axis=1)  # [B, bw]
        src = (jnp.arange(B)[:, None] * bw + order).reshape(-1)
        tokens = jnp.take(s.tokens, src, axis=0)
        seq_lens = jnp.take(s.seq_lens, src, axis=0)
        cum = jnp.take(s.cum_log_probs, src, axis=0)
        slp = (
            None if s.step_log_probs is None
            else jnp.take(s.step_log_probs, src, axis=0)
        )
        return tokens, seq_lens, cum, slp

    if stepwise:
        def step(params, inputs, s):
            s = beam_advance(params, inputs, s)
            return engine._forward_newest(st, params, s, beam_width=bw)

        return (
            engine.jit(beam_prefill),
            engine.jit(step, donate_argnums=(2,)),
            engine.jit(beam_advance, donate_argnums=(2,)),
            engine.jit(sort_outputs),
        )

    def run(params, inputs):
        s = beam_prefill(params, inputs)

        def cond(s):
            return jnp.logical_and(
                s.gen_step < st.output_len - 1, jnp.logical_not(jnp.all(s.finished))
            )

        def body(s):
            s = beam_advance(params, inputs, s)
            return engine._forward_newest(st, params, s, beam_width=bw)

        s = jax.lax.while_loop(cond, body, s)
        s = beam_advance(params, inputs, s)
        return sort_outputs(inputs, s)

    return engine.jit(run)
