"""Beam search served FROM the continuous-batching pool (VERDICT r4 item 2).

The reference's engine serves beams inside the same forward for any batch —
DynamicDecodeLayer dispatches to OnlineBeamSearchLayer when beam_width > 1
(/root/reference/src/fastertransformer/layers/DynamicDecodeLayer.cc:309-409)
and the KV cache rides a cache_indirection table (GptNeoX.cc:776-778,
1011-1017). Round 4's pool fell back to the static path for beams; this pool
serves them continuously: each SLOT holds ``beam_width`` device rows (the
tiled-prompt layout of sampling/beam.py, itself the reference's
invokeTileGptInputs scheme), requests join by chunk-prefilling all beam rows
and retire when every beam finishes, mid-flight with other requests.

Per-tick structure (mirrors the one-shot beam loop, sampling/beam.py):
  forward every row's newest token with the slot's beam indirection
  (kv_skip for finished beams, sacrifice-last writes) -> process logits
  (optional-last/bad-words/temperature/repetition/min-length, the
  BaseBeamSearchLayer::invokeAddBiasApplyPenalties order) -> per-beam
  top-bw -> diversity + GNMT length penalty -> cross-beam merge per slot ->
  row-state reorder + indirection update. Non-ready rows (mid-prefill or
  empty slots) pass through the merge untouched via an identity gather.

The cache stays FIXED; beam reassignment only ever moves the [rows, S] int32
indirection — never the multi-GB KV slabs. Decode attention resolves the
indirection with one-hot selects (engine/kv_cache.attend_decode_beam).

Not supported here (falls back to the static path in the handler): paged KV
(beam indirection addresses row-contiguous slabs), pipeline parallelism,
per-request beam widths differing from the pool's (width is a pool-level
static — a MultiPoolServer class per width serves mixed traffic).
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import gptneox as model
from ..sampling import processors as proc
from ..sampling.beam import _length_penalty_factor
from .batcher import ContinuousBatcher, Request, encode_word_list

NEG_INF = proc.NEG_INF


class BeamPool(ContinuousBatcher):
    """Slot pool where every slot decodes ``beam_width`` hypotheses."""

    def __init__(
        self,
        engine,
        max_slots: int = 4,
        beam_width: int = 2,
        max_seq_len: int = 2048,
        prompt_bucket: int = 128,
        stop_words_width: int = 16,
        bad_words_width: int = 16,
        optional_last_width: int = 8,
        return_log_probs: bool = False,
        pipeline_ticks: bool = False,
    ):
        assert beam_width >= 2, "beam_width 1 is the sampling pool"
        self.beam_width = int(beam_width)
        self._row_mult = self.beam_width  # rows = slots x beams (base reads it)
        super().__init__(
            engine,
            max_slots=max_slots,
            max_seq_len=max_seq_len,
            prompt_bucket=prompt_bucket,
            stop_words_width=stop_words_width,
            bad_words_width=bad_words_width,
            optional_last_width=optional_last_width,
            return_log_probs=return_log_probs,
            paged=None,
            pipeline_ticks=pipeline_ticks,
        )
        assert self._pp == 1, "beam pools under pipeline parallelism: use the static path"

    # ------------------------------------------------------------ state ----
    def _init_state(self):
        st = super()._init_state()
        R, S = self.rows, self.max_seq_len
        # beam extras; sampling-only fields stay (harmlessly) in the dict but
        # the beam step never reads top_k/top_p/pres_penalty/base_keys
        st["cum_lp"] = jnp.zeros((R,), jnp.float32)
        st["finished"] = jnp.zeros((R,), jnp.bool_)
        st["beam_indir"] = jnp.zeros((R, S), jnp.int32)
        st["diversity"] = jnp.zeros((R,), jnp.float32)
        st["len_penalty"] = jnp.zeros((R,), jnp.float32)
        return st

    # -------------------------------------------------------- admission ----
    def make_request(self, prompt, output_len, **kw):
        kw.pop("beam_width", None)  # pool-level static; tolerated in kw
        if kw.get("on_text") is not None:
            raise ValueError(
                "beam pools do not stream text (the best-so-far row changes "
                "under reorders); use on_token or the static path"
            )
        # beam search ignores top_k/top_p and the presence penalty (the
        # reference's DynamicDecodeLayer routes beam_width>1 to the beam
        # layers, whose penalty set is invokeAddBiasApplyPenalties)
        kw.pop("top_k", None)
        kw.pop("top_p", None)
        kw.pop("presence_penalty", None)
        kw.pop("random_seed", None)  # beam search is deterministic
        return super().make_request(prompt, output_len, **kw)

    def _get_admit_fn(self):
        if self._admit_fn is not None:
            return self._admit_fn
        S, bw = self.max_seq_len, self.beam_width
        end_id = self.cfg.end_id

        def admit(state, slot, ids, in_len, stop_at, temperature, rep_penalty,
                  min_length, stop_w, bad_w, olt, diversity, len_penalty):
            row = jnp.full((S,), end_id, jnp.int32)
            row = jax.lax.dynamic_update_slice(row, ids, (0,))
            row = jnp.where(jnp.arange(S) < in_len, row, end_id)
            rows = slot * bw + jnp.arange(bw)  # the slot's beam rows
            st = dict(state)

            def set_rows(name, val):
                st[name] = st[name].at[rows].set(val)

            set_rows("tokens", jnp.broadcast_to(row, (bw, S)))
            set_rows("seq_lens", in_len)
            set_rows("input_lens", in_len)
            set_rows("prefill_pos", 0)
            set_rows("stop_at", stop_at)
            set_rows("active", True)
            set_rows("temperature", temperature)
            set_rows("rep_penalty", rep_penalty)
            set_rows("min_length", min_length)
            set_rows("stop_words", jnp.broadcast_to(stop_w, (bw,) + stop_w.shape))
            set_rows("bad_words", jnp.broadcast_to(bad_w, (bw,) + bad_w.shape))
            set_rows("olt", jnp.broadcast_to(olt, (bw,) + olt.shape))
            set_rows("steps", 0)
            set_rows("diversity", diversity)
            set_rows("len_penalty", len_penalty)
            # beam init: only beam 0 proposes at the first merge
            set_rows("cum_lp", jnp.where(jnp.arange(bw) == 0, 0.0, NEG_INF))
            set_rows("finished", False)
            # every beam initially reads its own row's KV
            set_rows(
                "beam_indir",
                jnp.broadcast_to(
                    jnp.arange(bw, dtype=jnp.int32)[:, None], (bw, S)
                ),
            )
            return st

        self._admit_fn = self.engine.jit(admit, donate_argnums=(0,))
        return self._admit_fn

    def _admit(self, r: Request, slot: int) -> None:
        assert len(r.prompt) + r.output_len <= self.max_seq_len
        ids = np.full((self.max_seq_len,), self.cfg.end_id, np.int32)
        ids[: len(r.prompt)] = r.prompt
        stop_at = min(len(r.prompt) + r.output_len, self.max_seq_len)
        olt = np.full((self.optional_last_width,), -1, np.int32)
        if r.optional_last_tokens:
            olt[: len(r.optional_last_tokens)] = list(r.optional_last_tokens)
        self._state = self._get_admit_fn()(
            self._state,
            slot,
            jnp.asarray(ids),
            jnp.int32(len(r.prompt)),
            jnp.int32(stop_at),
            jnp.float32(r.temperature),
            jnp.float32(r.repetition_penalty),
            jnp.int32(r.min_length),
            jnp.asarray(encode_word_list(r.stop_words, self.stop_words_width)),
            jnp.asarray(encode_word_list(r.bad_words, self.bad_words_width)),
            jnp.asarray(olt),
            jnp.float32(r.beam_search_diversity_rate),
            jnp.float32(r.len_penalty),
        )
        r.slot = slot
        r._chunks_left = -(-max(len(r.prompt) - 1, 0) // self.prompt_bucket)
        self.running[slot] = r

    # ------------------------------------------------------------- tick ----
    def _build_step(self):
        cfg = self.cfg
        end_id = cfg.end_id
        R, S = self.rows, self.max_seq_len
        bw, nslots = self.beam_width, self.max_slots

        def step(params, state):
            target = jnp.maximum(state["input_lens"] - 1, 0)
            ready = state["active"] & (state["prefill_pos"] >= target)  # [R]
            positions = jnp.clip(state["seq_lens"] - 1, 0, S - 1)
            newest = state["tokens"][jnp.arange(R), positions]
            # forward ALL rows; finished beams and non-ready rows skip cache
            # writes (sacrifice-last), beam indirection resolves lineage
            hidden, cache = model.decode_step(
                cfg, params, newest, jnp.where(ready, positions, 0),
                state["cache"],
                beam=(bw, state["beam_indir"]),
                kv_skip=(~ready) | state["finished"],
                kv_skip_mode="sacrifice_last",
            )
            logits = model.lm_logits(cfg, params, hidden)

            # processor order = sampling/beam.py process_logits
            first_step = state["steps"] == 0
            masked = proc.apply_optional_last_tokens(logits, state["olt"], 1, True)
            logits = jnp.where(first_step[:, None], masked, logits)
            logits = proc.ban_bad_words(
                logits, state["tokens"], state["seq_lens"], state["bad_words"], 1
            )
            logits = proc.apply_temperature(logits, state["temperature"])
            buf_valid = jnp.arange(S)[None, :] < state["seq_lens"][:, None]
            logits = proc.apply_repetition_penalty(
                logits, state["tokens"], buf_valid, state["rep_penalty"]
            )
            gen_lens = state["seq_lens"] - state["input_lens"]
            logits = proc.apply_min_length(
                logits, gen_lens, state["min_length"], end_id
            )

            V = logits.shape[-1]
            log_probs = jax.nn.log_softmax(logits, axis=-1)
            finished_row = jnp.full((V,), NEG_INF, jnp.float32).at[end_id].set(0.0)
            log_probs = jnp.where(
                state["finished"][:, None], finished_row[None, :], log_probs
            )

            top_lp, top_id = jax.lax.top_k(log_probs, bw)  # [R, bw]
            cand_cum = state["cum_lp"][:, None] + top_lp
            rank = jnp.arange(bw, dtype=jnp.float32)[None, :]
            cand_score = cand_cum - state["diversity"][:, None] * rank
            new_lens = jnp.where(
                state["finished"], state["seq_lens"], state["seq_lens"] + 1
            )
            lp_factor = _length_penalty_factor(
                new_lens - state["input_lens"], state["len_penalty"]
            )
            cand_score = cand_score / lp_factor[:, None]

            # cross-beam merge per SLOT
            cand_score = cand_score.reshape(nslots, bw * bw)
            cand_cum = cand_cum.reshape(nslots, bw * bw)
            cand_id = top_id.reshape(nslots, bw * bw)
            _, sel = jax.lax.top_k(cand_score, bw)  # [nslots, bw]
            parent = sel // bw
            new_tok = jnp.take_along_axis(cand_id, sel, axis=1).reshape(-1)
            new_cum = jnp.take_along_axis(cand_cum, sel, axis=1).reshape(-1)
            src = (jnp.arange(nslots)[:, None] * bw + parent).reshape(-1)  # [R]
            # non-ready rows: identity pass-through (no reorder, no writes)
            src = jnp.where(ready, src, jnp.arange(R))

            tokens = jnp.take(state["tokens"], src, axis=0)
            seq_lens = jnp.take(state["seq_lens"], src, axis=0)
            finished = jnp.take(state["finished"], src, axis=0)
            cum_prev = jnp.take(state["cum_lp"], src, axis=0)
            indir = jnp.take(state["beam_indir"], src, axis=0)

            tok = jnp.where(finished | ~ready, end_id, new_tok)
            write_idx = jnp.clip(seq_lens, 0, S - 1)
            keep = finished | ~ready
            tokens = tokens.at[jnp.arange(R), write_idx].set(
                jnp.where(keep, tokens[jnp.arange(R), write_idx], tok)
            )
            # next forward writes row r's KV into row r itself at write_idx
            own = (jnp.arange(R, dtype=jnp.int32) % bw)
            indir = indir.at[jnp.arange(R), write_idx].set(
                jnp.where(keep, indir[jnp.arange(R), write_idx], own)
            )
            seq_lens = seq_lens + jnp.where(keep, 0, 1)
            cum_lp = jnp.where(keep, cum_prev, new_cum)

            newly = ready & ~finished & (
                (tok == end_id) | (seq_lens >= state["stop_at"])
            )
            newly = newly | (
                ready & ~finished & proc.stop_words_criterion(
                    tokens, seq_lens, state["stop_words"], 1
                )
            )
            finished = finished | newly

            slot_done = (ready & finished).reshape(nslots, bw).all(axis=1)
            st = dict(state)
            st["cache"] = cache
            st["tokens"] = tokens
            st["seq_lens"] = seq_lens
            st["cum_lp"] = cum_lp
            st["finished"] = finished
            st["beam_indir"] = indir
            st["active"] = state["active"] & ~jnp.repeat(slot_done, bw)
            st["steps"] = state["steps"] + jnp.where(ready, 1, 0)
            # emit beam-0's token per slot (streaming taps the best-so-far row)
            tok_slot = tok.reshape(nslots, bw)[:, 0]
            lp_slot = jnp.zeros((nslots,), jnp.float32)
            ready_slot = ready.reshape(nslots, bw).all(axis=1)
            return st, tok_slot, lp_slot, slot_done, ready_slot

        return step

    # ------------------------------------------------------------ retire ----
    def _process_results(self, fetched) -> List[Tuple[int, int, bool]]:
        tok_h, lp_h, fin_h, ready_h = fetched
        emitted = []
        for slot, r in list(self.running.items()):
            if not bool(ready_h[slot]):
                continue
            t = int(tok_h[slot])
            done = bool(fin_h[slot])
            emitted.append((r.uid, t, done))
            if r.on_token is not None:
                r.on_token(t)
            if done:
                rows = slice(slot * self.beam_width, (slot + 1) * self.beam_width)
                toks, lens, cum, lpen, in_lens = jax.device_get((
                    self._state["tokens"][rows],
                    self._state["seq_lens"][rows],
                    self._state["cum_lp"][rows],
                    self._state["len_penalty"][rows],
                    self._state["input_lens"][rows],
                ))
                # sort beams best-first by the length-penalized score
                # (sampling/beam.py sort_outputs)
                factor = np.power(
                    (5.0 + (lens - in_lens).astype(np.float32)) / 6.0,
                    lpen.astype(np.float32),
                )
                order = np.argsort(-(cum / factor), kind="stable")
                r.beam_output_ids = [
                    [int(x) for x in toks[j, : int(lens[j])]] for j in order
                ]
                r.beam_cum_log_probs = [float(cum[j]) for j in order]
                r.output_ids = r.beam_output_ids[0]
                r.cum_log_prob = r.beam_cum_log_probs[0]
                r.done = True
                del self.running[slot]
        return emitted
