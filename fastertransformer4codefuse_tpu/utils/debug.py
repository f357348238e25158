"""Debug / verification mode — the analog of the reference's forced-sync
kernel checking.

The reference turns ``sync_check_cuda_error()`` from a no-op into a
device-sync + error check after every kernel when ``FT_DEBUG_LEVEL=DEBUG``
(/root/reference/src/fastertransformer/utils/cuda_utils.h:129-154).  Under XLA
there is no per-kernel sync point to hook — the whole step is one compiled
program — so the equivalent capability is a *checkified* forward: prefill plus
one decode step re-run with a finiteness assertion after every layer, compiled
with ``jax.experimental.checkify`` so the failure is attributed to the first
offending layer instead of surfacing as garbage tokens N steps later.

Two tiers, mirroring the reference's check granularity:

- :func:`scan_params` — host-side sweep of the weight pytree; returns
  ``(path, bad_count)`` for every leaf containing NaN/Inf (the analog of
  FT_CHECK on weight-load).
- :func:`checked_forward` — device-side layer-attributed activation check
  (the analog of the per-kernel sync_check_cuda_error sweep).

Wired into the engine via ``RuntimeConfig.debug_level`` (defaults from the
``FT_DEBUG_LEVEL`` env var, same contract as the reference).
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import GptNeoXConfig
from ..models import gptneox as model
from ..models.params import Params


class DebugCheckError(RuntimeError):
    """A debug-mode finiteness check failed (layer-attributed message)."""


def _iter_leaves(tree, prefix=""):
    """Yield (path, leaf) with human-readable paths; QuantizedTensor scales
    are checked (the int payloads are finite by construction)."""
    from ..models.params import QuantizedTensor

    if isinstance(tree, QuantizedTensor):
        yield prefix + ".scale", tree.scale
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], f"{prefix}.{k}" if prefix else k)
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, f"{prefix}[{i}]")
        return
    yield prefix, tree


def scan_params(params: Params) -> List[Tuple[str, int]]:
    """Host sweep: every float leaf with non-finite entries, as (path, count).

    For stacked-[L] per-layer tensors the path is the slot name; the count
    covers all layers (use ``checked_forward`` for the layer attribution).
    """
    bad = []
    for path, leaf in _iter_leaves(params):
        if leaf is None or not hasattr(leaf, "dtype"):
            continue
        if not jnp.issubdtype(leaf.dtype, jnp.floating):
            continue
        n = int(jax.device_get(jnp.size(leaf) - jnp.isfinite(leaf).sum()))
        if n:
            bad.append((path, n))
    return bad


def checked_forward(
    config: GptNeoXConfig,
    params: Params,
    input_ids,  # [B, S] int32 (right-padded)
    input_lengths,  # [B]
    cache_dtype=jnp.bfloat16,
) -> None:
    """Run prefill + one decode step with a checkify finiteness assertion after
    every layer, the final layernorm, and the logits.  Raises
    :class:`DebugCheckError` naming the first offending stage.

    This is deliberately a separate, debug-only program: the serving loop stays
    check-free (zero overhead), exactly like the reference where the per-kernel
    checks compile away unless FT_DEBUG_LEVEL=DEBUG.
    """
    from jax.experimental import checkify

    input_ids = jnp.asarray(input_ids, jnp.int32)
    input_lengths = jnp.asarray(input_lengths, jnp.int32)
    B, S = input_ids.shape

    def fwd(params, input_ids, input_lengths):
        cache = model.init_kv_cache(config, B, S + 1, dtype=cache_dtype)
        x = model._embed_lookup(params, input_ids)
        checkify.check(jnp.isfinite(x).all(), "non-finite embeddings")

        cos_t, sin_t = model.make_rotary_tables(
            S + 1, config.rotary_embedding_dim, config.rotary_base
        )
        mask = model.make_prefill_mask(input_lengths, S)

        def prefill_fn(lp, x, c, l):
            y, c = model.block_prefill(
                config, lp, x, c, l, cos_t[:S], sin_t[:S], mask, input_lengths
            )
            checkify.check(
                jnp.isfinite(y).all(),
                "non-finite activation after layer {l} (prefill)",
                l=l,
            )
            return y, c

        x, cache = model._scan_layers(config, params, x, cache, prefill_fn)

        # one decode step at position input_lengths
        last = model.last_token_hidden(x, input_lengths)
        h = model.final_norm(config, params, last)
        checkify.check(jnp.isfinite(h).all(), "non-finite final layernorm (prefill)")
        logits = model.lm_logits(config, params, h)
        checkify.check(jnp.isfinite(logits).all(), "non-finite logits (prefill)")
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)

        positions = input_lengths
        cos = jnp.take(cos_t, positions, axis=0)[:, None, :]
        sin = jnp.take(sin_t, positions, axis=0)[:, None, :]
        valid = model.make_decode_valid(positions, S + 1)
        xd = model._embed_lookup(params, tok)[:, None, :]

        def decode_fn(lp, x, c, l):
            y, c = model.block_decode(
                config, lp, x, c, l, cos, sin, positions, valid
            )
            checkify.check(
                jnp.isfinite(y).all(),
                "non-finite activation after layer {l} (decode)",
                l=l,
            )
            return y, c

        xd, cache = model._scan_layers(config, params, xd, cache, decode_fn)
        h = model.final_norm(config, params, xd[:, 0])
        logits = model.lm_logits(config, params, h)
        checkify.check(jnp.isfinite(logits).all(), "non-finite logits (decode)")
        return tok

    checked = checkify.checkify(fwd, errors=checkify.user_checks)
    err, _ = jax.jit(checked)(params, input_ids, input_lengths)
    try:
        err.throw()
    except Exception as e:  # checkify raises JaxRuntimeError/ValueError
        raise DebugCheckError(str(e)) from None


def debug_verify(engine, input_ids, input_lengths) -> None:
    """Engine hook: parameter sweep + layer-attributed checked forward.

    Called by ``GptNeoXEngine.generate`` when ``RuntimeConfig.debug_level`` is
    ``DEBUG`` (or the ``FT_DEBUG_LEVEL`` env var says so), mirroring the
    reference's opt-in forced-sync mode.
    """
    bad = scan_params(engine.params)
    if bad:
        listing = ", ".join(f"{p} ({n} bad)" for p, n in bad[:8])
        raise DebugCheckError(f"non-finite weights: {listing}")
    checked_forward(
        engine.config,
        engine.params,
        np.asarray(input_ids, np.int32),
        np.asarray(input_lengths, np.int32),
        cache_dtype=engine._cache_dtype(),
    )
