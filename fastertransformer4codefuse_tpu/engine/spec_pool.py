"""Speculative decoding served FROM the continuous-batching pool.

Retires the last static-path fallback (STATUS r4/r5 "Remaining pool
fallbacks"): the pool's uniform 1-token tick was incompatible with
speculation's variable commit widths — this pool makes the TICK itself a
(k+1)-wide verify. Every tick, each ready slot proposes its own n-gram
draft from its token buffer (the prompt-lookup matcher of
engine/speculative.py), ONE [rows, k+1] chunked forward — the SAME
``models.prefill_chunk`` program admission chunks ride — verifies all
slots, and per-slot commit lengths advance independently: a slot that
accepted 5 drafts moves 6 tokens this tick while its neighbor moves 1.
Admission, chunked prefill overlap, priority queuing, pipelined ticks, and
the server/MultiPool seams are all inherited unchanged.

The reference has no speculative machinery at all (one token per forward,
/root/reference/src/fastertransformer/models/gptneox/GptNeoX.cc:1003-1052);
this is a beyond-reference capability, now at continuous-batching parity
with the plain sampling pool.

Greedy-only by construction (the same eligibility set as the static
speculative path, api/handler._spec_eligible): every committed token equals
its verify row's argmax, so sampling params/processors are rejected at
``make_request``. Dense KV, tp-meshable (prefill_chunk shards like the
base pool's chunks); not paged, not pp>1, no prompt tables.

Cache invariant (same as engine/speculative.py): rejected-draft K/V rows
sit beyond the committed length and every next tick's chunk REWRITES from
committed_len-1 before any query can see them.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from ..models import gptneox as model
from .batcher import ContinuousBatcher, Request
from .speculative import _propose_device


class SpecPool(ContinuousBatcher):
    """Slot pool whose decode tick is a (k+1)-wide speculative verify."""

    def __init__(self, engine, k: int = 8, ngram: int = 3, **kw):
        engine.check_speculation()
        assert kw.get("paged") is None, "speculative pool is dense-KV only"
        assert kw.get("prompt_table") is None, (
            "speculative pool does not serve prompt learning"
        )
        kw.pop("paged", None)
        kw.pop("prompt_table", None)
        self.k = int(k)
        self.ngram = int(ngram)
        super().__init__(engine, **kw)
        assert self._pp == 1, "speculative pool under pp>1: use the static path"

    # -------------------------------------------------------- admission ----
    def make_request(self, prompt, output_len, **kw):
        kw.pop("random_seed", None)  # greedy: deterministic
        r = super().make_request(prompt, output_len, **kw)
        C = self.k + 1
        if len(r.prompt) + r.output_len > self.max_seq_len - (C + 1):
            raise ValueError(
                f"speculative pool needs a {C + 1}-token draft margin: "
                f"prompt+output must be <= {self.max_seq_len - (C + 1)}"
            )
        for name, val, want in (
            ("top_k", r.top_k, 1), ("top_p", r.top_p, 0.0),
            ("temperature", r.temperature, 1.0),
            ("repetition_penalty", r.repetition_penalty, 1.0),
            ("presence_penalty", r.presence_penalty, 0.0),
            ("min_length", r.min_length, 0),
        ):
            if val != want:
                raise ValueError(
                    f"speculative pool is greedy-only: {name} must be {want}"
                )
        if any(r.stop_words or []) or any(r.bad_words or []) or (
            r.optional_last_tokens
        ):
            raise ValueError(
                "speculative pool serves processor-free requests only "
                "(stop/bad words, optional-last: use the sampling pool)"
            )
        return r

    # ------------------------------------------------------------- tick ----
    def _build_step(self):
        cfg = self.cfg
        end_id = cfg.end_id
        B, S = self.rows, self.max_seq_len
        k, ngram, C = self.k, self.ngram, self.k + 1

        def step(params, state):
            target = jnp.maximum(state["input_lens"] - 1, 0)
            ready = state["active"] & (state["prefill_pos"] >= target)
            l = jnp.maximum(state["seq_lens"], 1)  # committed buffer length

            draft, has = jax.vmap(_propose_device, in_axes=(0, 0, None, None))(
                state["tokens"], l, ngram, k
            )  # [B, k], [B]
            last = state["tokens"][jnp.arange(B), jnp.clip(l - 1, 0, S - 1)]
            chunk = jnp.concatenate([last[:, None], draft], axis=1)  # [B, C]
            pos = jnp.clip(l - 1, 0, S - 1) + state["pos_offset"]
            hidden, cache = model.prefill_chunk(
                cfg, params, chunk, pos, state["cache"], ready
            )
            logits = model.lm_logits(cfg, params, hidden)  # [B, C, V]
            g = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [B, C]

            matches = draft == g[:, :k]
            m = jnp.sum(jnp.cumprod(matches.astype(jnp.int32), axis=1), axis=1)
            iota = jnp.arange(C)[None, :]
            ext = jnp.concatenate([draft, draft[:, -1:]], axis=1)
            bonus = jnp.take_along_axis(g, m[:, None], axis=1)
            cand = jnp.where(iota < m[:, None], ext, bonus)  # [B, C]
            is_end = (cand == end_id) & (iota <= m[:, None])
            first_end = jnp.min(jnp.where(is_end, iota, C), axis=1)  # [B]
            commit = jnp.minimum(
                jnp.minimum(m, first_end) + 1, state["stop_at"] - l
            )
            commit = jnp.where(ready, jnp.maximum(commit, 0), 0)

            def upd(row, l_b, cand_b, c_b):
                old = jax.lax.dynamic_slice(row, (l_b,), (C,))
                new = jnp.where(jnp.arange(C) < c_b, cand_b, old)
                return jax.lax.dynamic_update_slice(row, new, (l_b,))

            tokens = jax.vmap(upd)(
                state["tokens"], jnp.clip(l, 0, S - C), cand, commit
            )
            # per-row greedy log-probs of the verify rows (committed prefix
            # consumed host-side against the fetched commit count)
            lse = jax.nn.logsumexp(logits, axis=-1)
            lps = jnp.take_along_axis(logits, g[..., None], axis=2)[..., 0] - lse

            seq_lens = state["seq_lens"] + commit
            finished = ready & (
                (first_end < C) | (seq_lens >= state["stop_at"])
            )
            st = dict(state)
            st["cache"] = cache
            st["tokens"] = tokens
            st["seq_lens"] = seq_lens
            st["active"] = state["active"] & ~finished
            st["steps"] = state["steps"] + jnp.where(ready, 1, 0)
            return st, (cand, commit), lps, finished, ready

        return step

    # -------------------------------------------------------- results ----
    def _process_results(self, fetched) -> List[Tuple[int, int, bool]]:
        (cand_h, commit_h), lp_h, fin_h, ready_h = fetched
        emitted = []
        for slot, r in list(self.running.items()):
            if not bool(ready_h[slot]):
                continue
            c = int(commit_h[slot])
            done = bool(fin_h[slot])
            for j in range(c):
                t = int(cand_h[slot, j])
                emitted.append((r.uid, t, done and j == c - 1))
                r._emitted_admit += 1
                if self.return_log_probs:
                    r.cum_log_prob += float(lp_h[slot, j])
                    if r.step_log_probs is None:
                        r.step_log_probs = []
                    r.step_log_probs.append(float(lp_h[slot, j]))
                if r.on_token is not None:
                    r.on_token(t)
                if r._decoder is not None:
                    r._decoder.append_token(t)
            if done:
                row, n = jax.device_get(
                    (self._state["tokens"][slot], self._state["seq_lens"][slot])
                )
                r.output_ids = [int(x) for x in row[: int(n)]]
                r.done = True
                if r._decoder is not None and (
                    not r.output_ids or r.output_ids[-1] != self.cfg.end_id
                ):
                    r._decoder.append_token(self.cfg.end_id)
                del self.running[slot]
        return emitted
