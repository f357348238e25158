"""Pipeline parallelism: a "pp" mesh axis over contiguous layer blocks.

A rebuild of the reference's pipeline scheme
(/root/reference/src/fastertransformer/models/gptneox/GptNeoXDecoder.cc:94-120
contiguous layers-per-rank blocks, :252-265/:372-383 activation handoff at
stage edges, GptNeoX.cc:780-788 microbatch pipelining via getLocalBatchSize,
GptNeoX.cc:998-1021 end-of-step broadcast):

  - Stacked layer weights [L, ...] and the KV cache [L, B, nH, S, dh] are
    sharded on the L axis over the "pp" mesh axis — each stage holds
    L/pp contiguous layers and their cache slabs. A model bigger than one
    card's memory fits by raising pp.
  - The forward runs under ``jax.shard_map`` manual over "pp" only; "tp"/"dp"
    stay GSPMD-auto, so the per-layer single-all-reduce TP property inside a
    stage is untouched.
  - A tick ``fori_loop`` drives the stages with MICROBATCH pipelining: at
    tick t, stage s processes microbatch m = t - s (``lax.cond`` skips stages
    whose m is out of range, so ramp-up/down ticks do not stream weights).
    With M microbatches the loop runs M + pp - 1 ticks and in steady state
    every stage is busy — stage s runs microbatch m while stage s-1 runs
    m+1, the reference's scheme. Activations hop stage-to-stage via
    ``lax.ppermute``; finished microbatches wrap around the ring to stage 0,
    which accumulates the output and broadcasts it with one small psum at
    the end (the analog of the reference's per-step ftNcclBroadcast).

Microbatch axes are chosen per phase:

  - ``prefill`` splits the SEQUENCE into M contiguous chunks (the cache fills
    left-to-right, so chunk m's attention only needs chunks <= m — which its
    own stage wrote at earlier ticks; causality gives dependency-free
    pipelining with NO cache copies, every stage updates its slab in place).
    Prefill is compute-bound, so this converts PP from serial (1/pp
    utilization) to up-to-pp-fold throughput.
  - ``decode_step`` splits the BATCH into M row groups (the reference's
    getLocalBatchSize scheme). NOTE: batch-1-style decode is HBM-weight-bound;
    splitting rows re-streams each stage's weights once per microbatch, so
    M > 1 only pays when decode is compute-bound (large batch / long chunks).
    The default M=1 keeps the serial schedule (capacity-only PP), matching
    the reference's ``local_batch_size == batch_size`` fast path.

Sampling and the LM head run OUTSIDE the shard_map, replicated over "pp"
(GSPMD-auto): every stage redundantly computes the logits+sampling for its
copy of the broadcast hidden state, which is value-identical, so no separate
token broadcast is needed.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import GptNeoXConfig
from ..models import gptneox as model
from ..models.params import Params
from ..ops.attention import make_decode_valid, make_prefill_mask
from ..ops.rotary import make_rotary_tables


def _ring(pp: int):
    return [(i, (i + 1) % pp) for i in range(pp)]


def _pipe_loop(pp: int, M: int, inject, run_local, x0, cache, out0):
    """Microbatched pipeline driver (see module docstring).

    inject(m) -> x          microbatch m's stage-0 input (embedding)
    run_local(x, m, cache) -> (y, cache)   one stage's layer scan on mb m
    x0   — flight-buffer initial value (shape of one microbatch activation)
    out0 — output accumulator; stage 0 stores finished microbatch m via
           store(out, y, m). Returns out broadcast to every stage.
    """
    stage = jax.lax.axis_index("pp")

    def tick(t, carry):
        x_cur, cache, out = carry
        m = t - stage
        valid = jnp.logical_and(m >= 0, m < M)
        mc = jnp.clip(m, 0, M - 1)
        # stage 0's input is always a fresh injection; stages >0 consume what
        # arrived over the ring last tick
        x_in = jnp.where(stage == 0, inject(mc), x_cur)
        y, cache = jax.lax.cond(
            valid, run_local, lambda x, mm, c: (x, c), x_in, mc, cache
        )
        y = jax.lax.ppermute(y, "pp", _ring(pp))
        # after the hop, stage 0 holds the FINISHED microbatch t - (pp-1)
        fm = t - (pp - 1)
        fmc = jnp.clip(fm, 0, M - 1)
        store = jnp.logical_and(
            stage == 0, jnp.logical_and(fm >= 0, fm < M)
        )
        out = jnp.where(
            store, jax.lax.dynamic_update_index_in_dim(out, y, fmc, 0), out
        )
        return y, cache, out

    x, cache, out = jax.lax.fori_loop(0, M + pp - 1, tick, (x0, cache, out0))
    # broadcast stage 0's accumulated outputs to every stage
    out = jax.lax.psum(jnp.where(stage == 0, out, jnp.zeros_like(out)), "pp")
    return out, cache


def decode_step(
    config: GptNeoXConfig,
    mesh: Mesh,
    params: Params,
    tokens: jax.Array,  # [B] int32
    positions: jax.Array,  # [B] int32
    cache,
    beam=None,
    kv_skip=None,
    kv_skip_mode: str = "preserve",
    microbatches: int = 1,
):
    """Pipeline-parallel analog of models.gptneox.decode_step.

    ``microbatches`` splits the batch into M row groups pipelined across
    stages (reference: GptNeoX.cc:780-788). Returns (hidden [B, H] replicated
    over pp, cache updated in each stage's local slab)."""
    pp = mesh.shape["pp"]
    L = config.layer_num
    assert L % pp == 0, f"layer_num {L} must divide pp {pp}"
    Lpp = L // pp
    B = tokens.shape[0]
    M = int(microbatches)
    assert B % M == 0, f"batch {B} must divide microbatches {M}"
    mb = B // M
    embed_p = {"embed": params["embed"], "final_ln_w": params["final_ln_w"]}
    bw = beam[0] if beam is not None else 0
    beam_indir = beam[1] if beam is not None else jnp.zeros((1, 1), jnp.int32)
    if kv_skip is None:
        kv_skip_arg = jnp.zeros((B,), jnp.bool_)
        use_skip = False
    else:
        kv_skip_arg = kv_skip
        use_skip = True

    def f(layers_local, embed_p, tokens, positions, cache_local, beam_indir, kv_skip_a):
        S = cache_local["k"].shape[3]
        cos_t, sin_t = make_rotary_tables(
            S, config.rotary_embedding_dim, config.rotary_base
        )

        def inject(m):
            toks_m = jax.lax.dynamic_slice_in_dim(tokens, m * mb, mb)
            return model._embed_lookup(embed_p, toks_m)[:, None, :]

        def run_local(x, m, cache):
            r0 = m * mb
            pos_m = jax.lax.dynamic_slice_in_dim(positions, r0, mb)
            cos = jnp.take(cos_t, pos_m, axis=0)[:, None, :]
            sin = jnp.take(sin_t, pos_m, axis=0)[:, None, :]
            valid = make_decode_valid(pos_m, S)
            if bw:
                indir_m = jax.lax.dynamic_slice_in_dim(beam_indir, r0, mb)
                beam_t = (bw, indir_m)
            else:
                beam_t = None
            skip = (
                jax.lax.dynamic_slice_in_dim(kv_skip_a, r0, mb)
                if use_skip else None
            )
            # slice this microbatch's cache rows; M=1 slices the whole slab
            # (a no-op view). For M>1 the gather/scatter copies the rows —
            # acceptable in the compute-bound regime M>1 targets.
            c_m = jax.tree.map(
                lambda v: jax.lax.dynamic_slice_in_dim(v, r0, mb, axis=1),
                cache,
            )

            def body(carry, l):
                x, c = carry
                lp = model._layer_slice(layers_local, l)
                y, c = model.block_decode(
                    config, lp, x, c, l, cos, sin, pos_m, valid,
                    beam=beam_t, kv_skip=skip, kv_skip_mode=kv_skip_mode,
                )
                return (y, c), None

            (x, c_m), _ = jax.lax.scan(body, (x, c_m), jnp.arange(Lpp))
            cache = jax.tree.map(
                lambda full, part: jax.lax.dynamic_update_slice_in_dim(
                    full, part, r0, axis=1
                ),
                cache, c_m,
            )
            return x, cache

        out0 = jnp.zeros(
            (M, mb, 1, embed_p["final_ln_w"].shape[0]),
            embed_p["final_ln_w"].dtype,
        )
        out, cache_local = _pipe_loop(
            pp, M, inject, run_local, inject(jnp.int32(0)), cache_local, out0
        )
        return out.reshape(B, -1), cache_local

    fn = jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P("pp"), P(), P(), P(), P("pp"), P(), P()),
        out_specs=(P(), P("pp")),
        axis_names={"pp"},
        check_vma=False,
    )
    return fn(
        params["layers"], embed_p, tokens, positions, cache, beam_indir, kv_skip_arg
    )


def prefill(
    config: GptNeoXConfig,
    mesh: Mesh,
    params: Params,
    input_ids: jax.Array,  # [B, S] int32
    input_lengths: jax.Array,  # [B]
    cache,
    microbatches: int = 1,
):
    """Pipeline-parallel analog of models.gptneox.prefill.

    ``microbatches`` splits the SEQUENCE into M contiguous chunks pipelined
    across stages: stage s runs chunk m at tick s + m, so in steady state all
    pp stages compute concurrently (the throughput the reference gets from
    batch microbatches, recast along the axis that needs no cache copies —
    chunk m only attends to cache the same stage wrote at ticks < its own).
    Returns (hidden [B, S, H] replicated over pp, cache with [0, S) filled in
    each stage's local slab)."""
    pp = mesh.shape["pp"]
    L = config.layer_num
    assert L % pp == 0, f"layer_num {L} must divide pp {pp}"
    Lpp = L // pp
    B, S = input_ids.shape
    M = int(microbatches)
    assert S % M == 0, f"seq width {S} must divide microbatches {M}"
    C = S // M
    embed_p = {"embed": params["embed"], "final_ln_w": params["final_ln_w"]}

    if M == 1:
        return _prefill_whole(config, mesh, params, input_ids, input_lengths, cache)

    def f(layers_local, embed_p, input_ids, input_lengths, cache_local):
        S_cache = cache_local["k"].shape[3]
        cos_t, sin_t = make_rotary_tables(
            S_cache, config.rotary_embedding_dim, config.rotary_base
        )
        active = jnp.ones((B,), jnp.bool_)

        def inject(m):
            ids_m = jax.lax.dynamic_slice_in_dim(input_ids, m * C, C, axis=1)
            return model._embed_lookup(embed_p, ids_m)  # [B, C, H]

        def run_local(x, m, cache):
            pos = jnp.full((B,), m * C, jnp.int32)
            posc = jnp.clip(
                pos[:, None] + jnp.arange(C)[None, :], 0, S_cache - 1
            )
            cos = jnp.take(cos_t, posc, axis=0)
            sin = jnp.take(sin_t, posc, axis=0)
            # causal: query at position p sees keys <= p. Identical to the
            # whole-prompt mask for every query at a REAL position (padded
            # queries' outputs are never consumed; see engine packing notes).
            valid = jnp.arange(S_cache)[None, None, :] <= posc[:, :, None]

            def body(carry, l):
                x, c = carry
                lp = model._layer_slice(layers_local, l)
                y, c = model.block_prefill_chunk(
                    config, lp, x, c, l, cos, sin, pos, valid, active
                )
                return (y, c), None

            (x, cache), _ = jax.lax.scan(body, (x, cache), jnp.arange(Lpp))
            return x, cache

        out0 = jnp.zeros(
            (M, B, C, embed_p["final_ln_w"].shape[0]),
            embed_p["final_ln_w"].dtype,
        )
        out, cache_local = _pipe_loop(
            pp, M, inject, run_local, inject(jnp.int32(0)), cache_local, out0
        )
        # [M, B, C, H] -> [B, S, H]
        hidden = jnp.moveaxis(out, 0, 1).reshape(B, S, -1)
        return hidden, cache_local

    fn = jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P("pp"), P(), P(), P(), P("pp")),
        out_specs=(P(), P("pp")),
        axis_names={"pp"},
        check_vma=False,
    )
    return fn(params["layers"], embed_p, input_ids, input_lengths, cache)


def prefill_chunk(
    config: GptNeoXConfig,
    mesh: Mesh,
    params: Params,
    tokens_chunk: jax.Array,  # [B, C] int32
    pos: jax.Array,  # [B] int32 — per-row chunk start slot (prompt offsets)
    cache,
    active: jax.Array,  # [B] bool
    embeds: Optional[jax.Array] = None,  # [B, C, H] pre-embedded (soft prompts)
):
    """Pipeline-parallel analog of models.gptneox.prefill_chunk: one C-wide
    chunk through every stage's layer block with PER-ROW start offsets.

    This is what prompt learning needs under pp>1 (the reference plumbs
    prompts through its PP path too, GptNeoX.cc:443-509): the prefix K/V
    occupy cache slots [0, p_len) per row, so the input prefills at per-row
    offsets ``pos`` and attends over everything at positions <= its own.
    Serial schedule (one chunk = nothing to microbatch)."""
    pp = mesh.shape["pp"]
    Lpp = config.layer_num // pp
    B, C = tokens_chunk.shape
    embed_p = {"embed": params["embed"], "final_ln_w": params["final_ln_w"]}
    use_embeds = embeds is not None
    if embeds is None:  # fixed operand list for the shard_map signature
        embeds = jnp.zeros((1, 1, 1), embed_p["final_ln_w"].dtype)

    def f(layers_local, embed_p, tokens_chunk, pos, cache_local, active, embeds):
        S_cache = cache_local["k"].shape[3]
        x = embeds if use_embeds else model._embed_lookup(embed_p, tokens_chunk)
        cos_t, sin_t = make_rotary_tables(
            S_cache, config.rotary_embedding_dim, config.rotary_base
        )
        posc = jnp.clip(pos[:, None] + jnp.arange(C)[None, :], 0, S_cache - 1)
        cos = jnp.take(cos_t, posc, axis=0)
        sin = jnp.take(sin_t, posc, axis=0)
        # query at position pos+c sees keys at positions <= pos+c — including
        # the prompt-prefix slots [0, pos) every stage preloaded in its slab
        valid = jnp.arange(S_cache)[None, None, :] <= posc[:, :, None]

        def inject(m):
            return x

        def run_local(x, m, cache):
            def body(carry, l):
                x, c = carry
                lp = model._layer_slice(layers_local, l)
                y, c = model.block_prefill_chunk(
                    config, lp, x, c, l, cos, sin, pos, valid, active
                )
                return (y, c), None

            (x, cache), _ = jax.lax.scan(body, (x, cache), jnp.arange(Lpp))
            return x, cache

        out0 = jnp.zeros((1,) + x.shape, x.dtype)
        out, cache_local = _pipe_loop(
            pp, 1, inject, run_local, x, cache_local, out0
        )
        return out[0], cache_local

    fn = jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P("pp"), P(), P(), P(), P("pp"), P(), P()),
        out_specs=(P(), P("pp")),
        axis_names={"pp"},
        check_vma=False,
    )
    return fn(
        params["layers"], embed_p, tokens_chunk, pos, cache, active, embeds
    )


def _prefill_whole(config, mesh, params, input_ids, input_lengths, cache):
    """M=1 path: whole-prompt block_prefill per stage (serial pipeline),
    keeping the exact op shapes of the single-chip engine."""
    pp = mesh.shape["pp"]
    Lpp = config.layer_num // pp
    B, S = input_ids.shape
    embed_p = {"embed": params["embed"], "final_ln_w": params["final_ln_w"]}

    def f(layers_local, embed_p, input_ids, input_lengths, cache_local):
        x = model._embed_lookup(embed_p, input_ids)
        cos_t, sin_t = make_rotary_tables(
            S, config.rotary_embedding_dim, config.rotary_base
        )
        mask = make_prefill_mask(input_lengths, S)

        def inject(m):
            return x

        def run_local(x, m, cache):
            def body(carry, l):
                x, c = carry
                lp = model._layer_slice(layers_local, l)
                y, c = model.block_prefill(
                    config, lp, x, c, l, cos_t, sin_t, mask, input_lengths
                )
                return (y, c), None

            (x, cache), _ = jax.lax.scan(body, (x, cache), jnp.arange(Lpp))
            return x, cache

        out0 = jnp.zeros((1,) + x.shape, x.dtype)
        out, cache_local = _pipe_loop(
            pp, 1, inject, run_local, x, cache_local, out0
        )
        return out[0], cache_local

    fn = jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P("pp"), P(), P(), P(), P("pp")),
        out_specs=(P(), P("pp")),
        axis_names={"pp"},
        check_vma=False,
    )
    return fn(params["layers"], embed_p, input_ids, input_lengths, cache)
