"""GPT-NeoX transformer, functional and scan-based.

Functional re-design of the reference engine's compute graph:
  - prefill  ≙ GptNeoXContextDecoder
    (/root/reference/src/fastertransformer/models/gptneox/GptNeoXContextDecoder.cc:223-511)
  - decode   ≙ GptNeoXDecoder single-token step
    (/root/reference/src/fastertransformer/models/gptneox/GptNeoXDecoder.cc:196-389)

The block implements both residual schemes:
  gptj (parallel) residual:  out = x + attn(ln1(x)) + ffn(ln2(x)) + bias_sum
    — the reference's single-all-reduce-per-layer trick
      (GptNeoXDecoder.cc:342-360, invokeAddBiasAttentionFfnResidual). Under
      GSPMD the same property emerges: attn_out and ffn_out are both partial
      sums over the TP axis, so XLA inserts exactly one all-reduce for their sum.
  serial residual:           h = x + attn(ln1(x)) + b_proj; out = h + ffn(ln2(h)) + b_down

Layers are stacked [L, ...] and driven by ``lax.scan`` — one compiled block body
regardless of depth, mirroring how the reference loops over per-layer weight
structs but with a single compiled program.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.config import GptNeoXConfig
from ..ops.attention import (
    make_decode_valid,
    make_prefill_mask,
    prefill_attention,
)
from ..ops.layernorm import layernorm, rmsnorm
from ..ops.linear import linear
from ..ops.rotary import apply_rotary, make_rotary_tables
from ..engine import kv_cache as kvc
from .params import Params, QuantizedTensor

KVCache = dict  # stacked cache pytree, see engine.kv_cache


def init_kv_cache(
    config: GptNeoXConfig, batch: int, max_seq_len: int, dtype=jnp.bfloat16
) -> KVCache:
    """Dense preallocated KV cache ([L, B, nH, S, dh] slabs; bf16 or int8 with
    per-vector scales) — see engine.kv_cache."""
    return kvc.init_cache(config, batch, max_seq_len, dtype)


def _norm(config: GptNeoXConfig, x: jax.Array, w: jax.Array, b) -> jax.Array:
    """Pre-norm dispatch: LayerNorm (GPT-NeoX/J) or RMSNorm (LLaMA family)."""
    if config.norm == "rmsnorm":
        return rmsnorm(x, w, config.layernorm_eps)
    return layernorm(x, w, b, config.layernorm_eps)


def _addb(x: jax.Array, b) -> jax.Array:
    """Residual bias add; bias-less families (use_bias=False) pass None."""
    return x if b is None else x + b.astype(x.dtype)


def _layer_slice(layers: Dict[str, Any], l) -> Dict[str, Any]:
    """Per-layer view: plain arrays are dynamically indexed (the slice fuses
    into their consumers); QuantizedTensors stay STACKED and ``linear``
    indexes them by ``layer``."""
    return {
        k: (v if isinstance(v, QuantizedTensor) else v[l])
        for k, v in layers.items()
    }


def _qkv(config: GptNeoXConfig, lp, x, cos, sin, layer=None):
    """ln1 -> fused QKV -> split heads -> rotary. x: [B, S, H].

    "interleaved" layout (GPT-NeoX/J): qkv_w's flat output axis is ordered
    (head, qkv, dh) — HF's native layout — so the per-head q/k/v split is a
    reshape, never a transpose. "concat" layout ([q all | k all | v all]) is
    the GQA form where q and kv head counts differ (LLaMA family)."""
    B, S, _ = x.shape
    nH, dh = config.head_num, config.size_per_head
    qkv = linear(x, lp["qkv_w"], lp.get("qkv_b"), layer=layer)
    # [B, S, (nH + 2*nKV) * dh]
    if config.qkv_layout == "concat":
        nKV = config.kv_heads
        q = qkv[..., : nH * dh].reshape(B, S, nH, dh)
        k = qkv[..., nH * dh : (nH + nKV) * dh].reshape(B, S, nKV, dh)
        v = qkv[..., (nH + nKV) * dh :].reshape(B, S, nKV, dh)
    else:
        qkv = qkv.reshape(B, S, nH, 3, dh)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    rot = config.rotary_embedding_dim
    q = apply_rotary(q, cos, sin, rot, config.rotary_style)
    k = apply_rotary(k, cos, sin, rot, config.rotary_style)
    return q, k, v


def _ffn(config: GptNeoXConfig, lp, x, layer=None, token_valid=None):
    if config.moe_experts:
        # Mixture-of-Experts FFN (Mixtral family): top-k routed expert GEMMs
        # with the E axis sharded under expert parallelism (ops/moe.py).
        # token_valid [B, S] keeps padding / inactive-slot tokens from
        # consuming expert capacity that belongs to real tokens.
        from ..ops.moe import moe_ffn

        B, S, H = x.shape
        y = moe_ffn(
            x.reshape(-1, H), lp["router_w"], lp.get("egate_w"),
            lp["eup_w"], lp["edown_w"], config.moe_top_k,
            config.moe_capacity_factor, act=config.activation,
            valid=None if token_valid is None else token_valid.reshape(-1),
        )
        return y.reshape(B, S, H)
    # bias + activation fuse into the up-GEMM's epilogue (XLA fusion) = the
    # reference's invokeAddBiasGeluV2 epilogue
    if config.gated_ffn:
        # SwiGLU (LLaMA family): h = act(x @ gate) * (x @ up)
        g = linear(
            x, lp["gate_w"], lp.get("gate_b"), layer=layer, act=config.activation
        )
        h = g * linear(x, lp["up_w"], lp.get("up_b"), layer=layer)
    else:
        h = linear(x, lp["up_w"], lp.get("up_b"), layer=layer, act=config.activation)
    # down bias applied by caller (residual fusion)
    return linear(h, lp["down_w"], layer=layer)


def block_prefill(
    config: GptNeoXConfig,
    lp: Dict[str, Any],
    x: jax.Array,  # [B, S, H]
    cache: KVCache,  # full stacked cache (updated in place at `layer`)
    layer: jax.Array,
    cos: jax.Array,  # [S, rot/2]
    sin: jax.Array,
    mask: jax.Array,  # [B, S, S]
    input_lengths=None,
):
    B, S, H = x.shape
    sm_scale = 1.0 / (config.size_per_head ** 0.5)

    ln1 = _norm(config, x, lp["ln1_w"], lp.get("ln1_b"))
    q, k, v = _qkv(config, lp, ln1, cos, sin, layer)

    cache = kvc.write_prefill(cache, layer, k, v)

    attn = prefill_attention(q, k, v, mask, sm_scale, input_lengths)  # [B, S, nH, dh]
    attn_out = linear(attn.reshape(B, S, H), lp["proj_w"], layer=layer)

    tv = None
    if config.moe_experts:  # keep padding out of the MoE capacity buckets
        tv = jnp.arange(S)[None, :] < input_lengths[:, None]
    if config.use_gptj_residual:
        ln2 = _norm(config, x, lp["ln2_w"], lp.get("ln2_b"))
        ffn_out = _ffn(config, lp, ln2, layer, token_valid=tv)
        # single fused residual: x + attn + ffn + summed bias
        # (= invokeAddBiasAttentionFfnResidual, add_residual_kernels.cu)
        out = _addb(x + attn_out + ffn_out, lp.get("down_b"))
    else:
        h = _addb(x + attn_out, lp.get("proj_b"))
        ln2 = _norm(config, h, lp["ln2_w"], lp.get("ln2_b"))
        out = _addb(
            h + _ffn(config, lp, ln2, layer, token_valid=tv), lp.get("down_b")
        )
    return out, cache


def block_decode(
    config: GptNeoXConfig,
    lp: Dict[str, Any],
    x: jax.Array,  # [B, 1, H] — the newest token
    cache: KVCache,  # full stacked cache (updated in place at `layer`)
    layer: jax.Array,
    cos: jax.Array,  # [B, 1, rot/2] at per-row positions
    sin: jax.Array,
    positions: jax.Array,  # [B] int32: slot of each row's new token
    valid: jax.Array,  # [B, S_max] — cache slots that participate
    beam=None,  # (beam_width, indirection [B, S_max]) — fixed-cache beam search
    kv_skip=None,  # [B] bool — rows whose write must not disturb readable state
    kv_skip_mode: str = "preserve",  # | "sacrifice_last" (kv_cache.write_decode)
):
    B, S, H = x.shape
    nH, dh = config.head_num, config.size_per_head
    sm_scale = 1.0 / (config.size_per_head ** 0.5)
    rot = config.rotary_embedding_dim

    ln1 = _norm(config, x, lp["ln1_w"], lp.get("ln1_b"))
    q, k, v = _qkv(config, lp, ln1, cos, sin, layer)  # [B, 1, nH, dh]

    cache = kvc.write_decode(
        cache, layer, k, v, positions, skip=kv_skip, skip_mode=kv_skip_mode
    )

    attn = kvc.attend_decode(
        cache, layer, q[:, 0], valid, sm_scale, positions, beam=beam
    )  # [B, nH, dh]

    attn_out = linear(attn.reshape(B, 1, H), lp["proj_w"], layer=layer)

    tv = None
    if config.moe_experts and kv_skip is not None:
        tv = (~kv_skip)[:, None]  # inactive pool slots skip MoE capacity
    if config.use_gptj_residual:
        ln2 = _norm(config, x, lp["ln2_w"], lp.get("ln2_b"))
        ffn_out = _ffn(config, lp, ln2, layer, token_valid=tv)
        out = _addb(x + attn_out + ffn_out, lp.get("down_b"))
    else:
        h = _addb(x + attn_out, lp.get("proj_b"))
        ln2 = _norm(config, h, lp["ln2_w"], lp.get("ln2_b"))
        out = _addb(
            h + _ffn(config, lp, ln2, layer, token_valid=tv), lp.get("down_b")
        )
    return out, cache


def block_prefill_chunk(
    config: GptNeoXConfig,
    lp: Dict[str, Any],
    x: jax.Array,  # [B, C, H] — C consecutive prompt tokens per row
    cache: KVCache,
    layer: jax.Array,
    cos: jax.Array,  # [B, C, rot/2] at per-row chunk positions
    sin: jax.Array,
    pos: jax.Array,  # [B] int32 — chunk start slot per row
    valid: jax.Array,  # [B, C, S_max] — keys visible to each query
    active: jax.Array,  # [B] bool — rows actually prefilling (others preserved)
):
    """Chunked prefill block: like block_prefill but the chunk attends over the
    already-filled pool cache (positions < pos + c). Lets the continuous
    batcher admit prompts one chunk per tick instead of stalling the decode
    pool for a whole-prompt prefill (the reference has no analog — its batches
    are static, GptNeoX.cc:386-1052)."""
    B, C, H = x.shape
    sm_scale = 1.0 / (config.size_per_head ** 0.5)

    ln1 = _norm(config, x, lp["ln1_w"], lp.get("ln1_b"))
    q, k, v = _qkv(config, lp, ln1, cos, sin, layer)  # [B, C, nH, dh]

    cache = kvc.write_chunk(cache, layer, k, v, pos, active)
    attn = kvc.attend_chunk(cache, layer, q, valid, sm_scale)  # [B, C, nH, dh]
    attn_out = linear(attn.reshape(B, C, H), lp["proj_w"], layer=layer)

    tv = None
    if config.moe_experts:
        tv = jnp.broadcast_to(active[:, None], (B, C))
    if config.use_gptj_residual:
        ln2 = _norm(config, x, lp["ln2_w"], lp.get("ln2_b"))
        ffn_out = _ffn(config, lp, ln2, layer, token_valid=tv)
        out = _addb(x + attn_out + ffn_out, lp.get("down_b"))
    else:
        h = _addb(x + attn_out, lp.get("proj_b"))
        ln2 = _norm(config, h, lp["ln2_w"], lp.get("ln2_b"))
        out = _addb(
            h + _ffn(config, lp, ln2, layer, token_valid=tv), lp.get("down_b")
        )
    return out, cache


def prefill_chunk(
    config: GptNeoXConfig,
    params: Params,
    tokens_chunk: jax.Array,  # [B, C] int32 — this tick's chunk per row
    pos: jax.Array,  # [B] int32 — chunk start (multiple of C; < S_max)
    cache: KVCache,
    active: jax.Array,  # [B] bool — rows mid-prefill
    rotary_tables=None,
    embeds: jax.Array = None,  # [B, C, H] — pre-embedded chunk (soft prompts);
    # overrides the token lookup (tokens_chunk then only fixes C)
) -> Tuple[jax.Array, KVCache]:
    """One chunked-prefill step over the whole layer stack.

    Fills cache positions [pos, pos+C) for active rows; inactive rows'
    cache bytes are preserved. Returns (hidden [B, C, H], cache)."""
    B, C = tokens_chunk.shape
    S = kvc.seq_len_of(cache)
    x = _embed_lookup(params, tokens_chunk) if embeds is None else embeds

    if rotary_tables is None:
        rotary_tables = make_rotary_tables(
            S, config.rotary_embedding_dim, config.rotary_base
        )
    cos_t, sin_t = rotary_tables
    posc = jnp.clip(pos[:, None] + jnp.arange(C)[None, :], 0, S - 1)  # [B, C]
    x = _add_pos_embed(config, params, x, posc, bound=S)
    cos = jnp.take(cos_t, posc, axis=0)  # [B, C, rot/2]
    sin = jnp.take(sin_t, posc, axis=0)
    # query at position pos+c sees keys at positions <= pos+c
    valid = jnp.arange(S)[None, None, :] <= posc[:, :, None]  # [B, C, S]

    fn = lambda lp, x, c, l: block_prefill_chunk(
        config, lp, x, c, l, cos, sin, pos, valid, active
    )
    x, cache = _scan_layers(config, params, x, cache, fn)
    return x, cache


def _scan_layers(config, params, x, cache, per_layer_fn, unroll=False):
    """Run the layer stack via lax.scan over the layer index.

    Both the cache and the weights stay OUT of scan xs/ys: the cache rides the
    carry (in-place updates at the layer index), plain per-layer tensors are
    dynamically indexed in the body (the slice fuses into consumers), and
    quantized weights stay stacked (``linear`` indexes them by layer).
    The xs/ys form re-assembles stacked slabs with a full copy every call.

    ``unroll=True`` runs a plain Python loop instead — only for offline tools
    that need concrete per-layer values outside jit (ckpt.calibrate's
    activation-statistics taps)."""
    layers = params["layers"]
    L = config.layer_num

    def body(carry, l):
        x, cache = carry
        lp = _layer_slice(layers, l)
        y, cache = per_layer_fn(lp, x, cache, l)
        return (y, cache), None

    if unroll:
        carry = (x, cache)
        for l in range(L):
            carry, _ = body(carry, jnp.int32(l))
        return carry
    (x, cache), _ = jax.lax.scan(body, (x, cache), jnp.arange(L))
    return x, cache


def _embed_lookup(params: Params, ids: jax.Array) -> jax.Array:
    """Token embedding gather; supports int8 embeddings (per-row scales)."""
    e = params["embed"]
    if isinstance(e, QuantizedTensor):
        x = jnp.take(e.q, ids, axis=0).astype(jnp.float32)
        s = jnp.take(e.scale, ids, axis=0)[..., None]
        return (x * s).astype(params["final_ln_w"].dtype)
    return jnp.take(e, ids, axis=0)


def _add_pos_embed(
    config, params: Params, x: jax.Array, positions, bound: int = None
) -> jax.Array:
    """Additive learned absolute position embeddings (GPT-2/OPT lineage —
    the reference's multi_gpu_gpt position_encoding table,
    src/fastertransformer/models/multi_gpu_gpt ParallelGpt weight
    position_encoding_table). positions: [S] or [B, S(, ...)] int32 into
    params["pos_embed"] [max_pos, H]. ``bound`` is the static upper bound on
    any position this call can produce (sequence length / cache capacity):
    it must fit the table, otherwise jnp.take would silently CLAMP
    out-of-range positions to the last row and degrade output."""
    if config.position_embedding != "learned":
        return x
    table = params["pos_embed"]
    if bound is not None:
        assert bound <= table.shape[0], (
            f"sequence capacity {bound} exceeds the learned position table "
            f"({table.shape[0]} rows) — this model cannot serve contexts "
            "beyond its trained n_positions"
        )
    pe = jnp.take(table, positions, axis=0)
    if pe.ndim == x.ndim - 1:  # shared [S, H] across the batch
        pe = pe[None]
    return x + pe.astype(x.dtype)


def prefill(
    config: GptNeoXConfig,
    params: Params,
    input_ids: jax.Array,  # [B, S] int32 (right-padded)
    input_lengths: jax.Array,  # [B]
    cache: KVCache,
    unroll: bool = False,  # Python layer loop (offline calibration taps only)
) -> Tuple[jax.Array, KVCache]:
    """Full-prompt forward. Returns (hidden [B, S, H], cache with [0,S) filled)."""
    B, S = input_ids.shape
    x = _embed_lookup(params, input_ids)
    x = _add_pos_embed(config, params, x, jnp.arange(S), bound=S)

    cos_t, sin_t = make_rotary_tables(S, config.rotary_embedding_dim, config.rotary_base)
    mask = make_prefill_mask(input_lengths, S)

    fn = lambda lp, x, c, l: block_prefill(
        config, lp, x, c, l, cos_t, sin_t, mask, input_lengths
    )
    x, cache = _scan_layers(config, params, x, cache, fn, unroll=unroll)
    return x, cache


def decode_step(
    config: GptNeoXConfig,
    params: Params,
    tokens: jax.Array,  # [B] int32 — newest token ids
    positions: jax.Array,  # [B] int32 — slot/rotary position of each new token
    cache: KVCache,
    rotary_tables: Optional[Tuple[jax.Array, jax.Array]] = None,
    beam=None,
    kv_skip=None,
    kv_skip_mode: str = "preserve",
) -> Tuple[jax.Array, KVCache]:
    """One incremental decode step. Returns (hidden [B, H], updated cache)."""
    B = tokens.shape[0]
    cache_len = kvc.seq_len_of(cache)
    x = _embed_lookup(params, tokens)[:, None, :]  # [B,1,H]
    x = _add_pos_embed(config, params, x, positions[:, None], bound=cache_len)

    if rotary_tables is None:
        rotary_tables = make_rotary_tables(
            cache_len, config.rotary_embedding_dim, config.rotary_base
        )
    cos_t, sin_t = rotary_tables
    cos = jnp.take(cos_t, positions, axis=0)[:, None, :]  # [B, 1, rot/2]
    sin = jnp.take(sin_t, positions, axis=0)[:, None, :]

    valid = make_decode_valid(positions, cache_len)

    fn = lambda lp, x, c, l: block_decode(
        config, lp, x, c, l, cos, sin, positions, valid, beam=beam,
        kv_skip=kv_skip, kv_skip_mode=kv_skip_mode,
    )
    x, cache = _scan_layers(config, params, x, cache, fn)
    return x[:, 0], cache


def final_norm(config: GptNeoXConfig, params: Params, hidden: jax.Array) -> jax.Array:
    return _norm(config, hidden, params["final_ln_w"], params.get("final_ln_b"))


def lm_logits(config: GptNeoXConfig, params: Params, hidden: jax.Array) -> jax.Array:
    """fp32 logits, the analog of the reference's fp32-out LM-head GEMM
    (GptNeoX.cc:866-925)."""
    h = final_norm(config, params, hidden)
    w = params["lm_head"]  # [V, H] — contracted on H (both operands H-minor)
    h2 = h.reshape(-1, h.shape[-1])
    if isinstance(w, QuantizedTensor) and w.k_axis % w.q.ndim == 0:
        # int4 head stored transposed [H, V_pad] (ckpt.quantize.quantize_lm_head_int4)
        from ..ops.linear import quantized_matmul_transposed_head

        logits = quantized_matmul_transposed_head(h2, w)[:, : config.vocab_size]
    elif isinstance(w, QuantizedTensor):
        logits = jax.lax.dot_general(
            h2,
            w.q.astype(h2.dtype),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        logits = logits * w.scale[None, :].astype(jnp.float32)
    else:
        logits = jax.lax.dot_general(
            h2,
            w,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    if "lm_head_b" in params:  # GPT-J's LM head carries a bias
        logits = logits + params["lm_head_b"].astype(jnp.float32)[None, :]
    # TP vocab padding: shard_params pads the vocab-split head up to a
    # multiple of the tp axis (the reference pads vocab to x8xTP,
    # GptNeoX.cc:260-264, and -inf-masks the pad ids in sampling,
    # invokeAddBiasEndMask); slicing the pad columns off entirely is the
    # stronger guarantee — no processor can ever sample a pad id.
    logits = logits[:, : config.vocab_size]
    return logits.reshape(h.shape[:-1] + (config.vocab_size,))


def last_token_hidden(hidden: jax.Array, input_lengths: jax.Array) -> jax.Array:
    """Gather the hidden state of each sequence's last real token
    (= invokeLookupHiddenStateOfLastToken, GptNeoXContextDecoder.cc:501)."""
    B = hidden.shape[0]
    idx = jnp.clip(input_lengths - 1, 0, hidden.shape[1] - 1)
    return hidden[jnp.arange(B), idx]
