"""Longformer encoder family — sliding-window + global attention.

The reference ships Longformer as its own C++ engine with dedicated
sliding-chunk kernels (/root/reference/src/fastertransformer/models/
longformer/LongformerEncoder.cc + kernels/longformer_kernels.cu); it is the
first family here whose ATTENTION PATTERN differs from causal/bidirectional —
the kernel-seam test VERDICT r4 item 5 asks for. Semantics (matching HF
LongformerModel exactly):

  - every token attends a symmetric window of ``attention_window[l] // 2``
    positions each side (per-layer windows), EXCLUDING global positions;
  - GLOBAL tokens are attended by every token (standard k/v projections),
    and their own output rows are recomputed with the separate
    query_global/key_global/value_global projections over the full sequence;
  - RoBERTa-style position ids (pad-offset cumsum), post-LN blocks, pooler.

Attention path: HF's chunked banded matmuls exist to avoid materializing the
[S, S] score matrix; here the band (plus global columns) is a dense mask over
one einsum, which XLA fuses. A banded kernel that visits only KV chunks
within the window (work ∝ S*w, not S², the longformer_kernels.cu analog) is
not written for the GPU yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layernorm import layernorm
from ..ops.linear import linear

MASK_VALUE = float(np.finfo(np.float32).min)  # HF uses dtype-min, not -inf


@dataclasses.dataclass(frozen=True)
class LongformerConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    max_position_embeddings: int
    attention_window: Tuple[int, ...]  # per-layer, even
    pad_token_id: int = 1
    type_vocab_size: int = 1
    inter_size: Optional[int] = None
    layernorm_eps: float = 1e-12
    activation: str = "gelu"
    model_name: str = "longformer"

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head


def config_from_hf_longformer(hf_config, model_name="longformer") -> LongformerConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)
    nH = g("num_attention_heads")
    H = g("hidden_size")
    win = g("attention_window")
    if isinstance(win, int):
        win = [win] * g("num_hidden_layers")
    return LongformerConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        vocab_size=g("vocab_size"),
        max_position_embeddings=g("max_position_embeddings"),
        attention_window=tuple(int(w) for w in win),
        pad_token_id=g("pad_token_id", 1),
        type_vocab_size=g("type_vocab_size", 1),
        inter_size=g("intermediate_size"),
        layernorm_eps=float(g("layer_norm_eps", 1e-12)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh",
                    "relu": "relu"}.get(g("hidden_act", "gelu"), "gelu"),
        model_name=model_name,
    )


def params_from_hf_longformer_state_dict(
    config: LongformerConfig, state_dict: Mapping[str, Any], dtype=jnp.float32
) -> Dict[str, Any]:
    from ..ckpt.convert import _np, stack_layers

    sd = dict(state_dict)
    pre = "longformer." if "longformer.embeddings.word_embeddings.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    L = config.layer_num

    def stack(fn):
        return stack_layers(fn, L, dtype)

    def aw(i, which, part):  # attention weight
        return get(f"encoder.layer.{i}.attention.self.{which}.{part}")

    layers = {}
    for which in ("query", "key", "value", "query_global", "key_global",
                  "value_global"):
        short = {"query": "q", "key": "k", "value": "v", "query_global": "qg",
                 "key_global": "kg", "value_global": "vg"}[which]
        layers[f"{short}_w"] = stack(lambda i, w=which: aw(i, w, "weight").T)
        layers[f"{short}_b"] = stack(lambda i, w=which: aw(i, w, "bias"))
    layers.update({
        "proj_w": stack(lambda i: get(f"encoder.layer.{i}.attention.output.dense.weight").T),
        "proj_b": stack(lambda i: get(f"encoder.layer.{i}.attention.output.dense.bias")),
        "attn_ln_w": stack(lambda i: get(f"encoder.layer.{i}.attention.output.LayerNorm.weight")),
        "attn_ln_b": stack(lambda i: get(f"encoder.layer.{i}.attention.output.LayerNorm.bias")),
        "up_w": stack(lambda i: get(f"encoder.layer.{i}.intermediate.dense.weight").T),
        "up_b": stack(lambda i: get(f"encoder.layer.{i}.intermediate.dense.bias")),
        "down_w": stack(lambda i: get(f"encoder.layer.{i}.output.dense.weight").T),
        "down_b": stack(lambda i: get(f"encoder.layer.{i}.output.dense.bias")),
        "out_ln_w": stack(lambda i: get(f"encoder.layer.{i}.output.LayerNorm.weight")),
        "out_ln_b": stack(lambda i: get(f"encoder.layer.{i}.output.LayerNorm.bias")),
    })
    out = {
        "embed": jnp.asarray(get("embeddings.word_embeddings.weight"), dtype),
        "pos_embed": jnp.asarray(get("embeddings.position_embeddings.weight"), dtype),
        "type_embed": jnp.asarray(get("embeddings.token_type_embeddings.weight"), dtype),
        "embed_ln_w": jnp.asarray(get("embeddings.LayerNorm.weight"), dtype),
        "embed_ln_b": jnp.asarray(get("embeddings.LayerNorm.bias"), dtype),
        "layers": layers,
    }
    if pre + "pooler.dense.weight" in sd:
        out["pooler_w"] = jnp.asarray(get("pooler.dense.weight").T, dtype)
        out["pooler_b"] = jnp.asarray(get("pooler.dense.bias"), dtype)
    return out


def _heads(x, nH, dh):
    B, S, _ = x.shape
    return x.reshape(B, S, nH, dh)


def _local_attention(q, k, v, w_half, is_masked, is_global):
    """Banded local attention plus global columns, as one dense mask.
    q (pre-scaled), k, v: [B, S, nH, dh]. Padded query rows come out zero."""
    S = q.shape[1]
    i = jnp.arange(S)
    in_band = jnp.abs(i[:, None] - i[None, :]) <= w_half  # [S, S]
    # allowed = global keys (everyone attends them, standard k/v) OR
    # in-band local non-global non-padding keys — the dense-mask form of
    # HF's [global cols | band] concat (it sums to the same softmax)
    allowed = (
        is_global[:, None, :]
        | (in_band[None] & ~is_masked[:, None, :] & ~is_global[:, None, :])
    )  # [B, S(q), S(k)]
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32)
    scores = jnp.where(allowed[:, None], scores, MASK_VALUE)
    probs = jax.nn.softmax(scores, axis=-1)
    # padded query rows: zero every prob (HF masked_fill on is_index_masked)
    probs = jnp.where(is_masked[:, None, :, None], 0.0, probs)
    return jnp.einsum("bhqk,bkhd->bqhd", probs.astype(v.dtype), v,
                      preferred_element_type=jnp.float32).astype(v.dtype)


def _attention(config, lp, x, w_half, is_masked, is_global):
    """One Longformer attention: banded local + global columns, then global
    rows recomputed with the *_global projections (LongformerSelfAttention
    semantics, modeling_longformer.py:485-620)."""
    B, S, H = x.shape
    nH, dh = config.head_num, config.size_per_head
    scale = 1.0 / (dh ** 0.5)
    q = _heads(linear(x, lp["q_w"], lp["q_b"]), nH, dh) * scale
    k = _heads(linear(x, lp["k_w"], lp["k_b"]), nH, dh)
    v = _heads(linear(x, lp["v_w"], lp["v_b"]), nH, dh)
    ctx = _local_attention(q, k, v, w_half, is_masked, is_global)

    # global rows: full attention with the dedicated global projections
    qg = _heads(linear(x, lp["qg_w"], lp["qg_b"]), nH, dh) * scale
    kg = _heads(linear(x, lp["kg_w"], lp["kg_b"]), nH, dh)
    vg = _heads(linear(x, lp["vg_w"], lp["vg_b"]), nH, dh)
    g_scores = jnp.einsum("bqhd,bkhd->bhqk", qg, kg,
                          preferred_element_type=jnp.float32)
    g_scores = jnp.where(is_masked[:, None, None, :], MASK_VALUE, g_scores)
    g_probs = jax.nn.softmax(g_scores, axis=-1).astype(x.dtype)
    g_ctx = jnp.einsum("bhqk,bkhd->bqhd", g_probs, vg,
                       preferred_element_type=jnp.float32).astype(x.dtype)
    ctx = jnp.where(is_global[:, :, None, None], g_ctx, ctx)
    return ctx.reshape(B, S, H)


def encode(
    config: LongformerConfig,
    params: Dict[str, Any],
    input_ids: jax.Array,  # [B, S] int32
    lengths: jax.Array,  # [B]
    global_mask: Optional[jax.Array] = None,  # [B, S] bool — global tokens
):
    """Full encoder pass -> (last_hidden [B, S, H], pooled or None)."""
    B, S = input_ids.shape
    real = jnp.arange(S)[None, :] < lengths[:, None]  # [B, S]
    is_masked = ~real
    if global_mask is None:
        is_global = jnp.zeros((B, S), bool)
    else:
        is_global = jnp.asarray(global_mask, bool) & real

    # RoBERTa-style positions: pad-offset cumsum over real tokens
    pos = jnp.cumsum(real.astype(jnp.int32), axis=1) * real + config.pad_token_id
    x = jnp.take(params["embed"], input_ids, axis=0)
    x = x + jnp.take(params["pos_embed"], pos, axis=0)
    x = x + jnp.take(
        params["type_embed"], jnp.zeros((B, S), jnp.int32), axis=0
    )
    x = layernorm(x, params["embed_ln_w"], params["embed_ln_b"],
                  config.layernorm_eps)

    layers = params["layers"]
    windows = jnp.asarray(
        [w // 2 for w in config.attention_window], jnp.int32
    )

    def body(carry, l):
        lp = {k: v[l] for k, v in layers.items()}
        a = _attention(config, lp, carry, windows[l], is_masked, is_global)
        a = linear(a, lp["proj_w"], lp["proj_b"])
        h = layernorm(carry + a, lp["attn_ln_w"], lp["attn_ln_b"],
                      config.layernorm_eps)
        f = linear(h, lp["up_w"], lp["up_b"], act=config.activation)
        f = linear(f, lp["down_w"], lp["down_b"])
        out = layernorm(h + f, lp["out_ln_w"], lp["out_ln_b"],
                        config.layernorm_eps)
        return out, None

    x, _ = jax.lax.scan(body, x, jnp.arange(config.layer_num))

    pooled = None
    if "pooler_w" in params:
        pooled = jnp.tanh(linear(x[:, 0], params["pooler_w"], params["pooler_b"]))
    return x, pooled
