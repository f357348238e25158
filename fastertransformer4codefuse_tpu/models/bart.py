"""BART encoder-decoder family — the reference's `bart` model class.

The reference serves BART through its T5-derived C++ engine path
(/root/reference/src/fastertransformer/models/bart/ — BartEncoder/Decoding
reuse the T5 kernels with learned positions and post-LN). Deltas vs the T5
family here (models/t5.py):

  - LEARNED absolute positions with BART's +2 offset (the fairseq legacy),
    applied from position 0 regardless of padding;
  - POST-LayerNorm blocks (residual -> LN) plus an embedding LayerNorm —
    T5 is pre-RMSNorm;
  - SCALED dot-product attention (q · dh^-0.5) — T5 is unscaled;
  - generation starts at decoder_start_token_id (= eos for BART) and HF
    forces eos_token_id at the final position when forced_eos_token_id is
    set (ForcedEosTokenLogitsProcessor) — replicated for greedy parity.

Cross-attention K/V project ONCE from the encoder output; the decoder
self-attention runs an incremental cache like every decode path here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layernorm import layernorm
from ..ops.linear import apply_act

MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


@dataclasses.dataclass(frozen=True)
class BartConfig:
    head_num: int
    size_per_head: int
    d_model: int
    layer_num: int  # encoder layers
    dec_layer_num: int
    vocab_size: int
    inter_size: int
    max_position_embeddings: int
    activation: str = "gelu"
    start_id: int = 2  # decoder_start_token_id (== eos for BART)
    end_id: int = 2
    forced_eos_id: int = 2  # -1 = disabled
    pos_offset: int = 2
    embed_scale: float = 1.0
    layernorm_eps: float = 1e-5
    model_name: str = "bart"


def config_from_hf_bart(hf_config, model_name="bart") -> BartConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)
    nH = g("encoder_attention_heads")
    D = g("d_model")
    feos = g("forced_eos_token_id")
    return BartConfig(
        head_num=nH,
        size_per_head=D // nH,
        d_model=D,
        layer_num=g("encoder_layers"),
        dec_layer_num=g("decoder_layers"),
        vocab_size=g("vocab_size"),
        inter_size=g("encoder_ffn_dim"),
        max_position_embeddings=g("max_position_embeddings"),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh",
                    "relu": "relu"}.get(g("activation_function", "gelu"), "gelu"),
        start_id=g("decoder_start_token_id", 2),
        end_id=g("eos_token_id", 2),
        forced_eos_id=-1 if feos is None else int(feos),
        embed_scale=(D ** 0.5) if g("scale_embedding", False) else 1.0,
        model_name=model_name,
    )


def params_from_hf_bart_state_dict(
    config: BartConfig, state_dict: Mapping[str, Any], dtype=jnp.float32
) -> Dict[str, Any]:
    from ..ckpt.convert import _np, stack_layers

    sd = dict(state_dict)
    pre = "model." if "model.shared.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    def attn_stack(side, L, which):
        def w(i):
            return get(f"{side}.layers.{i}.{which}.weight").T

        def b(i):
            return get(f"{side}.layers.{i}.{which}.bias")

        return stack_layers(w, L, dtype), stack_layers(b, L, dtype)

    def side_layers(side, L, cross):
        out = {}
        for short, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                            ("o", "out_proj")):
            out[f"{short}_w"], out[f"{short}_b"] = attn_stack(
                side, L, f"self_attn.{name}"
            )
        out["ln1_w"] = stack_layers(
            lambda i: get(f"{side}.layers.{i}.self_attn_layer_norm.weight"), L, dtype)
        out["ln1_b"] = stack_layers(
            lambda i: get(f"{side}.layers.{i}.self_attn_layer_norm.bias"), L, dtype)
        if cross:
            for short, name in (("xq", "q_proj"), ("xk", "k_proj"),
                                ("xv", "v_proj"), ("xo", "out_proj")):
                out[f"{short}_w"], out[f"{short}_b"] = attn_stack(
                    side, L, f"encoder_attn.{name}"
                )
            out["ln_x_w"] = stack_layers(
                lambda i: get(f"{side}.layers.{i}.encoder_attn_layer_norm.weight"), L, dtype)
            out["ln_x_b"] = stack_layers(
                lambda i: get(f"{side}.layers.{i}.encoder_attn_layer_norm.bias"), L, dtype)
        out["wi"] = stack_layers(lambda i: get(f"{side}.layers.{i}.fc1.weight").T, L, dtype)
        out["wi_b"] = stack_layers(lambda i: get(f"{side}.layers.{i}.fc1.bias"), L, dtype)
        out["wo"] = stack_layers(lambda i: get(f"{side}.layers.{i}.fc2.weight").T, L, dtype)
        out["wo_b"] = stack_layers(lambda i: get(f"{side}.layers.{i}.fc2.bias"), L, dtype)
        out["ln2_w"] = stack_layers(
            lambda i: get(f"{side}.layers.{i}.final_layer_norm.weight"), L, dtype)
        out["ln2_b"] = stack_layers(
            lambda i: get(f"{side}.layers.{i}.final_layer_norm.bias"), L, dtype)
        return out

    out = {
        "embed": jnp.asarray(get("shared.weight"), dtype),
        "enc_pos": jnp.asarray(get("encoder.embed_positions.weight"), dtype),
        "dec_pos": jnp.asarray(get("decoder.embed_positions.weight"), dtype),
        "enc": side_layers("encoder", config.layer_num, cross=False),
        "dec": side_layers("decoder", config.dec_layer_num, cross=True),
    }
    if pre + "encoder.layernorm_embedding.weight" in sd:  # Marian has none
        out["enc_eln_w"] = jnp.asarray(get("encoder.layernorm_embedding.weight"), dtype)
        out["enc_eln_b"] = jnp.asarray(get("encoder.layernorm_embedding.bias"), dtype)
        out["dec_eln_w"] = jnp.asarray(get("decoder.layernorm_embedding.weight"), dtype)
        out["dec_eln_b"] = jnp.asarray(get("decoder.layernorm_embedding.bias"), dtype)
    if "final_logits_bias" in sd:
        out["logits_bias"] = jnp.asarray(_np(sd["final_logits_bias"])[0], dtype)
    return out


def _mh(x, w, b, nH, dh):
    y = jnp.einsum("bsd,dn->bsn", x, w.astype(x.dtype),
                   preferred_element_type=jnp.float32).astype(x.dtype)
    y = y + b.astype(y.dtype)
    return y.reshape(x.shape[0], x.shape[1], nH, dh)


def _attn(q, k, v, bias, o_w, o_b):
    """Scaled attention (q pre-scaled by caller), additive bias/mask."""
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32) + bias
    p = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    ctx = jnp.einsum("bhqk,bkhd->bqhd", p, v,
                     preferred_element_type=jnp.float32).astype(q.dtype)
    B, Q = ctx.shape[0], ctx.shape[1]
    ctx = ctx.reshape(B, Q, -1)
    y = jnp.einsum("bqn,nd->bqd", ctx, o_w.astype(ctx.dtype),
                   preferred_element_type=jnp.float32).astype(q.dtype)
    return y + o_b.astype(y.dtype)


def encode(config: BartConfig, params, input_ids, lengths):
    """Encoder pass -> [B, S, D] (post-LN stack)."""
    from .params import layer_slice

    B, S = input_ids.shape
    nH, dh = config.head_num, config.size_per_head
    scale = dh ** -0.5
    x = jnp.take(params["embed"], input_ids, axis=0) * config.embed_scale
    x = x + params["enc_pos"][config.pos_offset: config.pos_offset + S][None]
    if "enc_eln_w" in params:
        x = layernorm(x, params["enc_eln_w"], params["enc_eln_b"],
                      config.layernorm_eps)
    pad = jnp.arange(S)[None, :] < lengths[:, None]
    bias = jnp.where(pad, 0.0, MASK_VALUE)[:, None, None, :]

    def body(carry, l):
        lp = layer_slice(params["enc"], l)
        q = _mh(carry, lp["q_w"], lp["q_b"], nH, dh) * scale
        a = _attn(q, _mh(carry, lp["k_w"], lp["k_b"], nH, dh),
                  _mh(carry, lp["v_w"], lp["v_b"], nH, dh), bias,
                  lp["o_w"], lp["o_b"])
        h = layernorm(carry + a, lp["ln1_w"], lp["ln1_b"], config.layernorm_eps)
        f = jnp.einsum("bsd,df->bsf", h, lp["wi"].astype(h.dtype),
                       preferred_element_type=jnp.float32).astype(h.dtype)
        f = apply_act(f + lp["wi_b"].astype(f.dtype), config.activation)
        f = jnp.einsum("bsf,fd->bsd", f, lp["wo"].astype(f.dtype),
                       preferred_element_type=jnp.float32).astype(f.dtype)
        f = f + lp["wo_b"].astype(f.dtype)
        return layernorm(h + f, lp["ln2_w"], lp["ln2_b"],
                         config.layernorm_eps), None

    x, _ = jax.lax.scan(body, x, jnp.arange(config.layer_num))
    return x


def init_decoder_state(config: BartConfig, params, enc_hidden, enc_lengths, S_out):
    from .params import layer_slice

    B, S_enc = enc_hidden.shape[0], enc_hidden.shape[1]
    nH, dh = config.head_num, config.size_per_head
    Ld = config.dec_layer_num

    def proj_all(w, b):
        y = jnp.einsum("bsd,ldn->lbsn", enc_hidden, w.astype(enc_hidden.dtype),
                       preferred_element_type=jnp.float32)
        y = (y + b[:, None, None, :]).astype(enc_hidden.dtype)
        return y.reshape(Ld, B, S_enc, nH, dh)

    dec = params["dec"]
    return {
        "self_k": jnp.zeros((Ld, B, S_out, nH, dh), enc_hidden.dtype),
        "self_v": jnp.zeros((Ld, B, S_out, nH, dh), enc_hidden.dtype),
        "cross_k": proj_all(dec["xk_w"], dec["xk_b"]),
        "cross_v": proj_all(dec["xv_w"], dec["xv_b"]),
        "enc_mask": jnp.where(
            jnp.arange(S_enc)[None, :] < enc_lengths[:, None], 0.0, MASK_VALUE
        ),
    }


@functools.partial(jax.jit, static_argnames=("config",))
def decode_step(config: BartConfig, params, state, tokens, pos):
    """One incremental decoder step -> (logits [B, V], state)."""
    from .params import layer_slice

    nH, dh = config.head_num, config.size_per_head
    scale = dh ** -0.5
    S_out = state["self_k"].shape[2]
    x = jnp.take(params["embed"], tokens, axis=0)[:, None] * config.embed_scale
    x = x + params["dec_pos"][config.pos_offset + pos][None, None]
    if "dec_eln_w" in params:
        x = layernorm(x, params["dec_eln_w"], params["dec_eln_b"],
                      config.layernorm_eps)

    k_pos = jnp.arange(S_out)
    causal = jnp.where(k_pos <= pos, 0.0, MASK_VALUE)[None, None, None, :]
    cross_bias = state["enc_mask"][:, None, None, :]
    dec = params["dec"]

    def body(carry, l):
        x, state = carry
        lp = layer_slice(dec, l)
        q = _mh(x, lp["q_w"], lp["q_b"], nH, dh) * scale
        k = _mh(x, lp["k_w"], lp["k_b"], nH, dh)
        v = _mh(x, lp["v_w"], lp["v_b"], nH, dh)
        sk = jax.lax.dynamic_update_slice(state["self_k"], k[None], (l, 0, pos, 0, 0))
        sv = jax.lax.dynamic_update_slice(state["self_v"], v[None], (l, 0, pos, 0, 0))
        state = dict(state, self_k=sk, self_v=sv)
        a = _attn(q, sk[l], sv[l], causal, lp["o_w"], lp["o_b"])
        x1 = layernorm(x + a, lp["ln1_w"], lp["ln1_b"], config.layernorm_eps)
        xq = _mh(x1, lp["xq_w"], lp["xq_b"], nH, dh) * scale
        ca = _attn(xq, state["cross_k"][l], state["cross_v"][l], cross_bias,
                   lp["xo_w"], lp["xo_b"])
        x2 = layernorm(x1 + ca, lp["ln_x_w"], lp["ln_x_b"], config.layernorm_eps)
        f = jnp.einsum("bsd,df->bsf", x2, lp["wi"].astype(x2.dtype),
                       preferred_element_type=jnp.float32).astype(x2.dtype)
        f = apply_act(f + lp["wi_b"].astype(f.dtype), config.activation)
        f = jnp.einsum("bsf,fd->bsd", f, lp["wo"].astype(f.dtype),
                       preferred_element_type=jnp.float32).astype(f.dtype)
        f = f + lp["wo_b"].astype(f.dtype)
        x3 = layernorm(x2 + f, lp["ln2_w"], lp["ln2_b"], config.layernorm_eps)
        return (x3, state), None

    (x, state), _ = jax.lax.scan(body, (x, state), jnp.arange(config.dec_layer_num))
    logits = jnp.einsum("bd,vd->bv", x[:, 0].astype(jnp.float32),
                        params["embed"].astype(jnp.float32))
    if "logits_bias" in params:
        logits = logits + params["logits_bias"].astype(jnp.float32)[None]
    return logits, state


def greedy_generate(config: BartConfig, params, input_ids, lengths, max_out: int):
    """Encoder + incremental greedy decode; HF semantics: starts at
    decoder_start_token_id, forces eos at the final position when
    forced_eos_token_id is set. Returns [B, max_out] (end_id-padded)."""
    enc = encode(config, params, input_ids, lengths)
    state = init_decoder_state(config, params, enc, lengths, max_out + 1)
    B = input_ids.shape[0]
    tok = jnp.full((B,), config.start_id, jnp.int32)
    outs = []
    finished = np.zeros((B,), bool)
    for t in range(max_out):
        logits, state = decode_step(config, params, state, tok, jnp.int32(t))
        if t == max_out - 1 and config.forced_eos_id >= 0:
            step = np.full((B,), config.forced_eos_id, np.int64)
        else:
            step = np.asarray(jnp.argmax(logits, axis=-1))
        step = np.where(finished, config.end_id, step)
        outs.append(step.astype(np.int32))
        finished |= step == config.end_id
        if finished.all():
            break
        tok = jnp.asarray(step.astype(np.int32))
    return np.stack(outs, axis=1)


def config_from_hf_marian(hf_config, model_name="marian") -> BartConfig:
    """Marian — the classic `decoder`/`decoding` engine analog (the
    reference's original seq2seq FT lineage, models/decoder + models/decoding):
    SINUSOIDAL positions (loaded verbatim from the checkpoint buffer, offset
    0), no embedding LayerNorm, otherwise the BART block structure."""
    cfg = config_from_hf_bart(hf_config, model_name=model_name)
    return dataclasses.replace(cfg, pos_offset=0)


def params_from_hf_marian_state_dict(config, state_dict, dtype=jnp.float32):
    return params_from_hf_bart_state_dict(config, state_dict, dtype)
