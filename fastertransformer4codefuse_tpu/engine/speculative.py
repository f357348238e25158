"""Prompt-lookup speculative decoding: multi-token greedy steps, no draft
model, ONE jitted device loop.

Code-generation outputs repeat their context heavily (identifiers, imports,
whole lines) — the serving regime CodeFuse targets. Prompt lookup (Saxena,
2023; the widely-deployed "assisted generation" n-gram variant) drafts the
next k tokens by matching the trailing n-gram against the tokens already in
context and copying what followed, then VERIFIES the whole draft in one
chunked forward.

Formulation: the WHOLE loop — n-gram matching, verify forward,
accept, commit — runs inside one ``lax.while_loop`` on device:

  - propose: the trailing n-gram compares against every window of the token
    buffer at once (n shifted equality vectors AND-ed — static n, no scan);
    the latest match's continuation is the draft. A missing match drafts
    padding, which verification simply rejects (that iteration emits one
    token, exactly a plain decode step).
  - verify: [last_committed, d1..dk] forwards through models.prefill_chunk —
    the SAME chunked program the continuous batcher uses (cache rows
    [p, p+C) written, logits for all C positions) — and greedy-argmaxes
    every position.
  - accept: the longest prefix of drafts matching the model's own argmaxes
    commits, plus the model's token at the first mismatch ("bonus"). Every
    emitted token is EXACTLY what greedy decoding through this same chunked
    program would produce (tested token-exact on CPU; on the GPU the
    one-shot engine's kernels may tie-break bf16 argmax ties differently —
    the spec path is self-consistent greedy, not bit-tied to a different
    kernel schedule).

Rejected-draft K/V left in the cache sit beyond the committed length, so the
position mask never reads them before their owning write rewrites them — the
batcher's chunk-prefill invariant.

A host-driven loop would pay one host round trip per verify; the device
loop's only sync is the final result. The reference has no speculative machinery at all (one token per forward,
GptNeoX.cc:1003-1052); measured in tools/speculative_probe.py.
"""
from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..models import gptneox as model
from ..ops import routes


def _jit_with_route(*static):
    """``jax.jit`` of a module-level program (its jit cache persists across
    calls) traced under the engine's routes, which it takes as the static
    second argument."""

    def wrap(fn):
        def traced(cfg, route, *args, **kwargs):
            with routes.use(route):
                return fn(cfg, *args, **kwargs)

        return jax.jit(traced, static_argnames=("cfg", "route") + static)

    return wrap


def propose_ngram(tokens: np.ndarray, n: int, k: int) -> np.ndarray:
    """Host reference of the device matcher (unit tests): the k tokens that
    followed the most recent earlier occurrence of ``tokens[-n:]``."""
    T = len(tokens)
    if T < n + 1:
        return np.empty((0,), np.int32)
    pattern = tokens[T - n:]
    win = np.lib.stride_tricks.sliding_window_view(tokens[: T - 1], n)
    hits = np.nonzero((win == pattern[None, :]).all(axis=1))[0]
    for start in hits[::-1]:
        cont = tokens[start + n: start + n + k]
        if len(cont):
            return cont.astype(np.int32)
    return np.empty((0,), np.int32)


def _propose_device(tokens: jax.Array, l: jax.Array, n: int, k: int):
    """Latest-match prompt lookup, fully vectorized. tokens [S] int32 with
    committed prefix [0, l). Returns draft [k] (padding when no match —
    harmless: verification rejects it)."""
    S = tokens.shape[0]
    pattern = jax.lax.dynamic_slice(tokens, (jnp.maximum(l - n, 0),), (n,))
    match = jnp.ones((S,), bool)
    for j in range(n):  # static n: j-shifted equality, AND-ed
        match &= jnp.roll(tokens, -j) == pattern[j]
    iota = jnp.arange(S)
    # window must START before the trailing occurrence and lie fully inside
    # the committed prefix
    match &= iota < l - n
    idx = jnp.max(jnp.where(match, iota, -1))
    start = jnp.clip(idx + n, 0, S - k)
    return jax.lax.dynamic_slice(tokens, (start,), (k,)), idx >= 0


@dataclasses.dataclass
class SpecStats:
    iterations: int = 0
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0
    cum_log_prob: float = 0.0  # sum of committed tokens' greedy log-probs

    @property
    def tokens_per_step(self) -> float:
        return self.emitted / max(self.iterations, 1)


@_jit_with_route()
def _spec_prefill(cfg, params, ids, n, cache):
    # module-level so the jit cache persists across speculative_generate
    # calls (a per-call closure would recompile the 13B prefill every time)
    hidden, cache = model.prefill(cfg, params, ids, n, cache)
    last = model.last_token_hidden(hidden, n)
    logits = model.lm_logits(cfg, params, last[:, None])[:, 0]
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    lp = (
        jnp.take_along_axis(logits, tok[:, None], axis=1)[:, 0]
        - jax.nn.logsumexp(logits, axis=-1)
    )
    return tok, lp, cache


@_jit_with_route("k", "ngram")
def _spec_loop(cfg, params, tokens, l0, cache, stop_at, k, ngram):
    # stop_at rides as a TRACED scalar: one compiled program per (k, ngram,
    # buffer length) serves every output_len (a static stop_at would
    # recompile the full model program per requested length)
    C = k + 1
    end_id = cfg.end_id

    def cond(carry):
        tokens, l, cache, done, it, acc, drf, lp = carry
        return (~done) & (l < stop_at)

    def body(carry):
        tokens, l, cache, done, it, acc, drf, lp = carry
        draft, has = _propose_device(tokens, l, ngram, k)

        last = jax.lax.dynamic_slice(tokens, (l - 1,), (1,))
        chunk = jnp.concatenate([last, draft])[None]  # [1, C]
        hidden, cache = model.prefill_chunk(
            cfg, params, chunk, jnp.array([0], jnp.int32) + (l - 1),
            cache, jnp.ones((1,), bool),
        )
        logits = model.lm_logits(cfg, params, hidden)  # [1, C, V]
        g = jnp.argmax(logits[0], axis=-1).astype(jnp.int32)  # [C]

        matches = draft == g[:k]
        m = jnp.sum(jnp.cumprod(matches.astype(jnp.int32)))  # leading run
        iota = jnp.arange(C)
        cand = jnp.where(iota < m, jnp.concatenate([draft, draft[-1:]]), g[m])
        # stop at the first emitted end_id and at the length budget
        is_end = (cand == end_id) & (iota <= m)
        first_end = jnp.min(jnp.where(is_end, iota, C))
        commit = jnp.minimum(jnp.minimum(m, first_end) + 1, stop_at - l)
        old = jax.lax.dynamic_slice(tokens, (l,), (C,))
        tokens = jax.lax.dynamic_update_slice(
            tokens, jnp.where(iota < commit, cand, old), (l,)
        )
        # cumulative log-prob of the COMMITTED tokens (every committed token
        # equals its row's greedy argmax, so its log-prob is
        # logits[i, g[i]] - logsumexp(logits[i]) — the reference's
        # cum_log_prob contract at ~zero extra cost)
        lse = jax.nn.logsumexp(logits[0], axis=-1)  # [C]
        chosen = jnp.take_along_axis(logits[0], g[:, None], axis=1)[:, 0]
        lp = lp + jnp.sum(jnp.where(iota < commit, chosen - lse, 0.0))
        l = l + commit
        done = (first_end < C) | (l >= stop_at)
        return (tokens, l, cache, done, it + 1,
                acc + m, drf + jnp.where(has, k, 0), lp)

    init = (tokens, l0, cache, jnp.asarray(False), jnp.int32(0),
            jnp.int32(0), jnp.int32(0), jnp.float32(0.0))
    (tokens, l, cache, done, it, acc, drf, lp) = jax.lax.while_loop(
        cond, body, init
    )
    return tokens, l, it, acc, drf, lp


@_jit_with_route("k", "ngram")
def _spec_loop_batched(cfg, params, tokens, l0, cache, stop_at, done0, k, ngram):
    """Batched analog of ``_spec_loop``: every row proposes its own draft,
    ONE [B, C] chunked forward verifies all rows, and per-row commit lengths
    advance independently. Finished rows ride along masked (active=~done in
    prefill_chunk preserves their cache bytes; commit forced 0) until every
    row is done — the whole batch stays inside one ``lax.while_loop``, so
    the host round-trip cost is unchanged from B=1."""
    C = k + 1
    end_id = cfg.end_id

    def cond(carry):
        tokens, l, cache, done, it, acc, drf, lp = carry
        return jnp.any(~done)

    def body(carry):
        tokens, l, cache, done, it, acc, drf, lp = carry
        draft, has = jax.vmap(_propose_device, in_axes=(0, 0, None, None))(
            tokens, l, ngram, k
        )  # [B, k], [B]
        last = jax.vmap(
            lambda row, i: jax.lax.dynamic_slice(row, (i - 1,), (1,))
        )(tokens, l)  # [B, 1]
        chunk = jnp.concatenate([last, draft], axis=1)  # [B, C]
        hidden, cache = model.prefill_chunk(
            cfg, params, chunk, l - 1, cache, ~done
        )
        logits = model.lm_logits(cfg, params, hidden)  # [B, C, V]
        g = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [B, C]

        matches = draft == g[:, :k]
        m = jnp.sum(jnp.cumprod(matches.astype(jnp.int32), axis=1), axis=1)
        iota = jnp.arange(C)[None, :]
        ext = jnp.concatenate([draft, draft[:, -1:]], axis=1)  # [B, C]
        bonus = jnp.take_along_axis(g, m[:, None], axis=1)  # [B, 1]
        cand = jnp.where(iota < m[:, None], ext, bonus)  # [B, C]
        is_end = (cand == end_id) & (iota <= m[:, None])
        first_end = jnp.min(jnp.where(is_end, iota, C), axis=1)  # [B]
        commit = jnp.minimum(jnp.minimum(m, first_end) + 1, stop_at - l)
        commit = jnp.where(done, 0, commit)

        def upd(row, l_b, cand_b, c_b):
            old = jax.lax.dynamic_slice(row, (l_b,), (C,))
            new = jnp.where(jnp.arange(C) < c_b, cand_b, old)
            return jax.lax.dynamic_update_slice(row, new, (l_b,))

        tokens = jax.vmap(upd)(tokens, l, cand, commit)
        lse = jax.nn.logsumexp(logits, axis=-1)  # [B, C]
        chosen = jnp.take_along_axis(logits, g[..., None], axis=2)[..., 0]
        lp = lp + jnp.sum(
            jnp.where(iota < commit[:, None], chosen - lse, 0.0), axis=1
        )
        acc = acc + jnp.where(done, 0, m)
        drf = drf + jnp.where((~done) & has, k, 0)
        l = l + commit
        done = done | (first_end < C) | (l >= stop_at)
        return (tokens, l, cache, done, it + 1, acc, drf, lp)

    B = tokens.shape[0]
    init = (tokens, l0, cache, done0, jnp.int32(0),
            jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.float32))
    (tokens, l, cache, done, it, acc, drf, lp) = jax.lax.while_loop(
        cond, body, init
    )
    return tokens, l, it, acc, drf, lp


def speculative_generate_batched(
    engine,
    prompts: List[List[int]],
    output_len: int,
    k: int = 8,
    ngram: int = 3,
) -> tuple[List[List[int]], List[SpecStats]]:
    """Batched greedy generation with per-row prompt-lookup speculation.

    Returns (per-row token sequences incl. prompt, per-row SpecStats). Each
    emitted token equals what B=1 ``speculative_generate`` (and hence plain
    greedy through the chunked program) would produce for that prompt; the
    loop runs until the SLOWEST row finishes, so iteration counts are shared
    across the batch. Two device dispatches total."""
    engine.check_speculation()
    cfg = engine.config
    params = engine.params
    B = len(prompts)
    if output_len <= 0:
        return [list(p) for p in prompts], [SpecStats() for _ in prompts]
    C = k + 1
    in_lens = [len(p) for p in prompts]
    S = max(in_lens) + output_len + C + 1
    bucket = max(engine.runtime.seq_bucket, C)
    S = -(-S // bucket) * bucket

    cache = model.init_kv_cache(cfg, B, S, engine._cache_dtype())

    ids = np.full((B, S), cfg.end_id, np.int32)
    for b, p in enumerate(prompts):
        ids[b, : len(p)] = p
    n = jnp.asarray(in_lens, jnp.int32)
    first, first_lp, cache = _spec_prefill(
        cfg, engine.routes, params, jnp.asarray(ids), n, cache
    )
    tokens = jnp.asarray(ids).at[jnp.arange(B), n].set(first)
    l0 = n + 1
    stop_at = n + output_len
    done0 = (first == cfg.end_id) | (l0 >= stop_at)

    tokens, l, it, acc, drf, lp = _spec_loop_batched(
        cfg, engine.routes, params, tokens, l0, cache, stop_at, done0, k=k, ngram=ngram,
    )
    tokens_h = np.asarray(tokens)
    l_h = np.asarray(l)
    it = int(it)
    outs: List[List[int]] = []
    stats: List[SpecStats] = []
    for b in range(B):
        out = [int(t) for t in tokens_h[b, : int(l_h[b])]]
        for i in range(in_lens[b], len(out)):
            if out[i] == cfg.end_id:
                out = out[: i + 1]
                break
        outs.append(out)
        stats.append(SpecStats(
            iterations=1 + it,
            drafted=int(drf[b]),
            accepted=int(acc[b]),
            emitted=len(out) - in_lens[b],
            cum_log_prob=float(first_lp[b]) + float(lp[b]),
        ))
    return outs, stats


def speculative_generate(
    engine,
    prompt: List[int],
    output_len: int,
    k: int = 8,
    ngram: int = 3,
) -> tuple[List[int], SpecStats]:
    """Greedy generation with prompt-lookup speculation (B=1).

    Returns (full token sequence incl. prompt, SpecStats). Two device
    dispatches total: the prompt prefill and the speculation while_loop."""
    engine.check_speculation()
    cfg = engine.config
    params = engine.params
    if output_len <= 0:
        return list(prompt), SpecStats()
    C = k + 1
    in_len = len(prompt)
    S = in_len + output_len + C + 1
    bucket = max(engine.runtime.seq_bucket, C)
    S = -(-S // bucket) * bucket

    cache = model.init_kv_cache(cfg, 1, S, engine._cache_dtype())

    ids = np.full((1, S), cfg.end_id, np.int32)
    ids[0, :in_len] = prompt
    first, first_lp, cache = _spec_prefill(
        cfg, engine.routes, params, jnp.asarray(ids), jnp.asarray([in_len], jnp.int32), cache
    )
    tokens = jnp.asarray(ids[0]).at[in_len].set(first[0])
    stop_at = in_len + output_len
    stats = SpecStats(iterations=1, emitted=1, cum_log_prob=float(first_lp[0]))
    if int(first[0]) == cfg.end_id or in_len + 1 >= stop_at:
        return [int(t) for t in np.asarray(tokens[: in_len + 1])], stats

    tokens, l, it, acc, drf, lp = _spec_loop(
        cfg, engine.routes, params, tokens, jnp.int32(in_len + 1), cache,
        jnp.int32(stop_at), k=k, ngram=ngram,
    )
    l = int(l)
    stats.iterations += int(it)
    stats.accepted = int(acc)
    stats.drafted = int(drf)
    stats.emitted = l - in_len
    stats.cum_log_prob += float(lp)
    out = [int(t) for t in np.asarray(tokens[:l])]
    # truncate at the first end_id after the prompt (committed by design)
    for i in range(in_len, len(out)):
        if out[i] == cfg.end_id:
            out = out[: i + 1]
            break
    stats.emitted = len(out) - in_len
    return out, stats
