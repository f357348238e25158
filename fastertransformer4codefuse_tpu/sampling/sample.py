"""Batched top-k / top-p token selection.

A rebuild of the reference's sampling layers
(/root/reference/src/fastertransformer/layers/sampling_layers/TopKSamplingLayer.cu,
TopPSamplingLayer.cu) and their kernels (sampling_topk_kernels.cu,
sampling_topp_kernels.cu). Semantics follow the reference's batched
top-k -> top-p chain (DynamicDecodeLayer.cc:410-468):

  - top_k > 0:  restrict to the k highest logits; if top_p > 0 further restrict
    to the smallest prefix of those whose probability mass reaches top_p.
  - top_k == 0, top_p > 0: pure nucleus sampling.
  - top_k == 0, top_p == 0: greedy (the reference's setup coerces this to k=1).

Instead of the reference's two-stage CUDA top-k + curand draw, we sort the
vocab once (descending), build a keep-mask from per-sample k/p, and draw via
Gumbel-max over the masked logits — mathematically identical to sampling the
renormalized truncated distribution. Per-sample k/p are data, not trace
constants, so heterogeneous batches never retrace.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .processors import NEG_INF


class SampleResult(NamedTuple):
    tokens: jax.Array  # [BB] int32
    log_probs: jax.Array  # [BB] f32 — log prob of the chosen token under the FULL
    # processed distribution (the reference pre-softmaxes the whole vocab when
    # cum_log_probs is requested: sampling_topk_kernels.cu:271-292). When the
    # caller passes need_log_probs=False this is zeros and the full-vocab
    # normalization (log_softmax / logsumexp over [B, V]) is skipped entirely —
    # the reference's return_cum_log_probs=0 contract, which gates the
    # softmax+log pass in sampling_topk_kernels.cu:271-292 off.


def sample_top_k_top_p(
    rngs: jax.Array,  # [BB] PRNG keys — per-sample seeds, like the reference's
    # per-batch curand states (BaseSamplingLayer.cc:32-33)
    logits: jax.Array,  # [BB, V] fp32, already processed (temperature etc.)
    top_k: jax.Array,  # [BB] int32, 0 = disabled
    top_p: jax.Array,  # [BB] f32, 0 = disabled
    need_log_probs: bool = True,
) -> SampleResult:
    BB, V = logits.shape
    k = top_k.astype(jnp.int32)
    p = top_p.astype(jnp.float32)
    # greedy coercion: k==0 and p==0 -> k=1
    k = jnp.where((k <= 0) & (p <= 0.0), 1, k)
    k = jnp.where(k > V, V, k)

    sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]  # descending
    ranks = jnp.argsort(jnp.argsort(logits, axis=-1)[:, ::-1], axis=-1)  # rank of each id

    # --- top-k mask over ranks -------------------------------------------------
    keep_k = jnp.where(k[:, None] > 0, ranks < k[:, None], True)

    # --- top-p mask (within the top-k-restricted distribution) ----------------
    kept_sorted = jnp.where(
        jnp.arange(V)[None, :] < jnp.where(k > 0, k, V)[:, None],
        sorted_logits,
        NEG_INF,
    )
    probs_sorted = jax.nn.softmax(kept_sorted, axis=-1)
    cum = jnp.cumsum(probs_sorted, axis=-1)
    # keep entries whose cumulative mass up to and including them minus own prob
    # is < p (always keep the argmax)
    keep_sorted_p = (cum - probs_sorted) < p[:, None]
    keep_sorted_p = keep_sorted_p.at[:, 0].set(True)
    keep_p_by_rank = jnp.take_along_axis(keep_sorted_p, ranks, axis=-1)
    keep_p = jnp.where(p[:, None] > 0.0, keep_p_by_rank, True)

    keep = keep_k & keep_p
    masked = jnp.where(keep, logits, NEG_INF)

    # --- Gumbel-max draw == categorical over the renormalized truncation ------
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(rngs)
    tokens = jnp.argmax(masked + gumbel, axis=-1).astype(jnp.int32)

    if not need_log_probs:
        return SampleResult(tokens=tokens, log_probs=jnp.zeros((BB,), jnp.float32))
    full_log_probs = jax.nn.log_softmax(logits, axis=-1)
    chosen_lp = jnp.take_along_axis(full_log_probs, tokens[:, None], axis=-1)[:, 0]
    return SampleResult(tokens=tokens, log_probs=chosen_lp)


def sample_top_k_top_p_capped(
    rngs: jax.Array,
    logits: jax.Array,  # [BB, V] fp32, processed
    top_k: jax.Array,  # [BB] int32, all in (0, cap]
    top_p: jax.Array,  # [BB] f32, 0 = disabled
    cap: int = 128,
    need_log_probs: bool = True,
) -> SampleResult:
    """Fast path when every row's top_k is in (0, cap]: one lax.top_k over the
    vocab instead of a full sort (the reference similarly caps top-k at 64,
    TopKSamplingLayer MAX_K). Semantics identical to sample_top_k_top_p for
    k <= cap."""
    BB, V = logits.shape
    cap = min(cap, V)  # tiny vocabs: lax.top_k requires k <= V
    vals, idxs = jax.lax.top_k(logits, cap)  # [BB, cap] descending
    ranks = jnp.arange(cap)[None, :]
    kept = jnp.where(ranks < top_k[:, None], vals, NEG_INF)
    probs = jax.nn.softmax(kept, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep_p = (cum - probs) < top_p[:, None]
    keep_p = keep_p.at[:, 0].set(True)
    keep_p = jnp.where(top_p[:, None] > 0.0, keep_p, True)
    masked = jnp.where(keep_p, kept, NEG_INF)

    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (cap,), jnp.float32))(rngs)
    pick = jnp.argmax(masked + gumbel, axis=-1)
    tokens = jnp.take_along_axis(idxs, pick[:, None], axis=-1)[:, 0].astype(jnp.int32)

    if not need_log_probs:
        return SampleResult(tokens=tokens, log_probs=jnp.zeros((BB,), jnp.float32))
    # cum_log_probs under the FULL distribution (reference semantics) — a
    # logsumexp reduce, no sort needed
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    chosen = jnp.take_along_axis(vals, pick[:, None], axis=-1)[:, 0]
    return SampleResult(tokens=tokens, log_probs=chosen - lse)


def sample_greedy(logits: jax.Array, need_log_probs: bool = True) -> SampleResult:
    """argmax fast path: no vocab sort, no RNG. Used when the host knows every
    sample in the batch is greedy (top_k==1, top_p==0). With
    need_log_probs=False the full-vocab fp32 log_softmax is skipped — at 13B
    that pass reads+writes [B, 100864] fp32 every step for a value the caller
    never looks at."""
    tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    if not need_log_probs:
        return SampleResult(
            tokens=tokens, log_probs=jnp.zeros((logits.shape[0],), jnp.float32)
        )
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    chosen_lp = jnp.take_along_axis(log_probs, tokens[:, None], axis=-1)[:, 0]
    return SampleResult(tokens=tokens, log_probs=chosen_lp)
