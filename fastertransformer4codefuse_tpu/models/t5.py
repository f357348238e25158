"""T5 encoder-decoder family — the reference's `t5` model class.

The reference serves T5 through its own C++ engine
(/root/reference/src/fastertransformer/models/t5/T5Encoder.cc + T5Decoding.cc
— relative-position-bias attention, cross-attention decoding); together with
the decoder-only zoo and the BERT encoder this covers all three architecture
classes the reference ships. T5 specifics handled here:

  - T5 "LayerNorm" is RMSNorm (no mean subtraction, no bias), pre-LN;
  - attention scores are UNSCALED (no 1/sqrt(dh) — folded into T5's init);
  - RELATIVE position biases: log-bucketed distance embeddings, held by the
    FIRST block of each stack and shared by all its layers (bidirectional
    buckets in the encoder, causal in the decoder);
  - cross-attention reads K/V projected ONCE from the encoder output;
  - tied LM head rescales decoder output by d_model**-0.5.

Greedy generation runs an incremental decoder (self-attention KV cache slabs
+ precomputed cross K/V) with one jitted step, mirroring the decoder
families' engine loop at family-support scope.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layernorm import rmsnorm
from ..ops.linear import apply_act

MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


@dataclasses.dataclass(frozen=True)
class T5Config:
    head_num: int
    size_per_head: int  # d_kv (NOT d_model / heads in general)
    d_model: int
    layer_num: int  # encoder layers
    dec_layer_num: int
    vocab_size: int
    inter_size: int
    num_buckets: int = 32
    max_distance: int = 128
    layernorm_eps: float = 1e-6
    activation: str = "relu"
    start_id: int = 0  # decoder_start_token_id
    end_id: int = 1
    tie_head: bool = True
    model_name: str = "t5"


def config_from_hf_t5(hf_config, model_name: str = "t5") -> T5Config:
    g = lambda k, d=None: getattr(hf_config, k, d)
    act = g("dense_act_fn", None) or (
        "gelu-tanh" if "gelu" in g("feed_forward_proj", "relu") else "relu"
    )
    return T5Config(
        head_num=g("num_heads"),
        size_per_head=g("d_kv"),
        d_model=g("d_model"),
        layer_num=g("num_layers"),
        dec_layer_num=g("num_decoder_layers") or g("num_layers"),
        vocab_size=g("vocab_size"),
        inter_size=g("d_ff"),
        num_buckets=g("relative_attention_num_buckets", 32),
        max_distance=g("relative_attention_max_distance", 128),
        layernorm_eps=float(g("layer_norm_epsilon", 1e-6)),
        activation={"relu": "relu", "gelu_new": "gelu-tanh",
                    "gelu": "gelu"}.get(act, "relu"),
        start_id=g("decoder_start_token_id") or 0,
        end_id=g("eos_token_id") or 1,
        tie_head=bool(g("tie_word_embeddings", True)),
        model_name=model_name,
    )


def params_from_hf_t5_state_dict(
    config: T5Config, state_dict: Mapping[str, Any], dtype=jnp.float32
) -> Dict[str, Any]:
    from ..ckpt.convert import _np

    sd = dict(state_dict)

    def get(name):
        return _np(sd[name])

    def stack(L, fn):
        from ..ckpt.convert import stack_layers

        return stack_layers(fn, L, dtype)

    def attn(pfx, i, which):
        return get(f"{pfx}.block.{i}.layer.0.SelfAttention.{which}.weight").T

    enc = {
        "ln1_w": stack(config.layer_num,
                       lambda i: get(f"encoder.block.{i}.layer.0.layer_norm.weight")),
        "q_w": stack(config.layer_num, lambda i: attn("encoder", i, "q")),
        "k_w": stack(config.layer_num, lambda i: attn("encoder", i, "k")),
        "v_w": stack(config.layer_num, lambda i: attn("encoder", i, "v")),
        "o_w": stack(config.layer_num, lambda i: attn("encoder", i, "o")),
        "ln2_w": stack(config.layer_num,
                       lambda i: get(f"encoder.block.{i}.layer.1.layer_norm.weight")),
        "wi": stack(config.layer_num,
                    lambda i: get(f"encoder.block.{i}.layer.1.DenseReluDense.wi.weight").T),
        "wo": stack(config.layer_num,
                    lambda i: get(f"encoder.block.{i}.layer.1.DenseReluDense.wo.weight").T),
    }
    Ld = config.dec_layer_num

    def dattn(i, lyr, which):
        name = "SelfAttention" if lyr == 0 else "EncDecAttention"
        return get(f"decoder.block.{i}.layer.{lyr}.{name}.{which}.weight").T

    dec = {
        "ln1_w": stack(Ld, lambda i: get(f"decoder.block.{i}.layer.0.layer_norm.weight")),
        "q_w": stack(Ld, lambda i: dattn(i, 0, "q")),
        "k_w": stack(Ld, lambda i: dattn(i, 0, "k")),
        "v_w": stack(Ld, lambda i: dattn(i, 0, "v")),
        "o_w": stack(Ld, lambda i: dattn(i, 0, "o")),
        "ln_x_w": stack(Ld, lambda i: get(f"decoder.block.{i}.layer.1.layer_norm.weight")),
        "xq_w": stack(Ld, lambda i: dattn(i, 1, "q")),
        "xk_w": stack(Ld, lambda i: dattn(i, 1, "k")),
        "xv_w": stack(Ld, lambda i: dattn(i, 1, "v")),
        "xo_w": stack(Ld, lambda i: dattn(i, 1, "o")),
        "ln2_w": stack(Ld, lambda i: get(f"decoder.block.{i}.layer.2.layer_norm.weight")),
        "wi": stack(Ld, lambda i: get(f"decoder.block.{i}.layer.2.DenseReluDense.wi.weight").T),
        "wo": stack(Ld, lambda i: get(f"decoder.block.{i}.layer.2.DenseReluDense.wo.weight").T),
    }
    out = {
        "embed": jnp.asarray(get("shared.weight"), dtype),
        "enc": enc,
        "dec": dec,
        "enc_rel_bias": jnp.asarray(
            get("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
            dtype,
        ),  # [num_buckets, nH]
        "dec_rel_bias": jnp.asarray(
            get("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
            dtype,
        ),
        "enc_final_ln_w": jnp.asarray(get("encoder.final_layer_norm.weight"), dtype),
        "dec_final_ln_w": jnp.asarray(get("decoder.final_layer_norm.weight"), dtype),
    }
    if "lm_head.weight" in sd and not config.tie_head:
        out["lm_head"] = jnp.asarray(get("lm_head.weight"), dtype)
    return out


def _rel_bucket(rel, bidirectional: bool, num_buckets: int, max_distance: int):
    """HF T5Attention._relative_position_bucket, vectorized.
    rel = memory_position - query_position."""
    rel = jnp.asarray(rel, jnp.int32)
    buckets = jnp.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n //= 2
        buckets += jnp.where(rel > 0, n, 0)
        rel = jnp.abs(rel)
    else:
        rel = -jnp.minimum(rel, 0)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        jnp.log(jnp.maximum(rel, 1).astype(jnp.float32) / max_exact)
        / np.log(max_distance / max_exact)
        * (n - max_exact)
    ).astype(jnp.int32)
    large = jnp.minimum(large, n - 1)
    return buckets + jnp.where(is_small, rel, large)


def _pos_bias(config: T5Config, table, q_pos, k_pos, bidirectional):
    """[nH, Q, K] additive attention bias from the bucket embedding table."""
    rel = k_pos[None, :] - q_pos[:, None]  # [Q, K]
    b = _rel_bucket(rel, bidirectional, config.num_buckets, config.max_distance)
    return jnp.take(table, b, axis=0).transpose(2, 0, 1)  # [nH, Q, K]


def _dot2(x, w, eq):
    """einsum ``eq`` with an optional per-output-channel int8 weight
    (convert-into-dot + post-scale — the same fpA-intB formulation as
    ops/linear, CutlassFpAIntBGemmRunner's math without the layout games)."""
    from .params import QuantizedTensor

    if isinstance(w, QuantizedTensor):
        y = jnp.einsum(eq, x, w.q.astype(x.dtype),
                       preferred_element_type=jnp.float32)
        scale = w.scale.astype(jnp.float32)
        return (y * scale[(None,) * (y.ndim - scale.ndim)]).astype(x.dtype)
    return jnp.einsum(eq, x, w.astype(x.dtype),
                      preferred_element_type=jnp.float32).astype(x.dtype)


def _layer_slice(layers, l):
    """Per-layer view of a stacked-params dict; QuantizedTensor-aware."""
    from .params import layer_slice

    return layer_slice(layers, l)


def _mh(x, w, nH, dh):
    """x [B, S, D] @ w [D, nH*dh] -> [B, S, nH, dh]."""
    y = _dot2(x, w, "bsd,dn->bsn")
    return y.reshape(x.shape[0], x.shape[1], nH, dh)


def _attn(q, k, v, bias, o_w):
    """Unscaled T5 attention. q [B,Q,nH,dh], k/v [B,K,nH,dh],
    bias [B or 1, nH, Q, K] additive (incl. padding mask)."""
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32)
    scores = scores + bias
    p = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    ctx = jnp.einsum("bhqk,bkhd->bqhd", p, v,
                     preferred_element_type=jnp.float32).astype(q.dtype)
    B, Q = ctx.shape[0], ctx.shape[1]
    ctx = ctx.reshape(B, Q, -1)
    return _dot2(ctx, o_w, "bqn,nd->bqd")


def encode(config: T5Config, params, input_ids, lengths):
    """Encoder pass -> [B, S, d_model] (final-RMSNorm applied)."""
    B, S = input_ids.shape
    nH, dh = config.head_num, config.size_per_head
    x = jnp.take(params["embed"], input_ids, axis=0)
    pad = jnp.arange(S)[None, :] < lengths[:, None]
    pos = jnp.arange(S)
    bias = _pos_bias(config, params["enc_rel_bias"], pos, pos, True)[None]
    bias = bias + jnp.where(pad, 0.0, MASK_VALUE)[:, None, None, :]
    layers = params["enc"]

    def body(carry, l):
        lp = _layer_slice(layers, l)
        h = rmsnorm(carry, lp["ln1_w"], config.layernorm_eps)
        a = _attn(_mh(h, lp["q_w"], nH, dh), _mh(h, lp["k_w"], nH, dh),
                  _mh(h, lp["v_w"], nH, dh), bias, lp["o_w"])
        x1 = carry + a
        h2 = rmsnorm(x1, lp["ln2_w"], config.layernorm_eps)
        f = apply_act(_dot2(h2, lp["wi"], "bsd,df->bsf"), config.activation)
        f = _dot2(f, lp["wo"], "bsf,fd->bsd")
        return x1 + f, None

    x, _ = jax.lax.scan(body, x, jnp.arange(config.layer_num))
    return rmsnorm(x, params["enc_final_ln_w"], config.layernorm_eps)


def init_decoder_state(config: T5Config, params, enc_hidden, enc_lengths, S_out):
    """Self-attn cache slabs + cross K/V projected ONCE from the encoder."""
    B, S_enc = enc_hidden.shape[0], enc_hidden.shape[1]
    nH, dh = config.head_num, config.size_per_head
    Ld = config.dec_layer_num
    dec = params["dec"]

    def proj_all(w):  # ONE batched GEMM over all layers, not Ld separate ones
        from .params import QuantizedTensor

        if isinstance(w, QuantizedTensor):  # stacked [Ld, D, n], scale [Ld, n]
            y = jnp.einsum(
                "bsd,ldn->lbsn", enc_hidden, w.q.astype(enc_hidden.dtype),
                preferred_element_type=jnp.float32,
            )
            y = y * w.scale.astype(jnp.float32)[:, None, None, :]
        else:
            y = jnp.einsum(
                "bsd,ldn->lbsn", enc_hidden, w.astype(enc_hidden.dtype),
                preferred_element_type=jnp.float32,
            )
        return y.astype(enc_hidden.dtype).reshape(Ld, B, S_enc, nH, dh)

    xk = proj_all(dec["xk_w"])
    xv = proj_all(dec["xv_w"])
    return {
        "self_k": jnp.zeros((Ld, B, S_out, nH, dh), enc_hidden.dtype),
        "self_v": jnp.zeros((Ld, B, S_out, nH, dh), enc_hidden.dtype),
        "cross_k": xk,  # [Ld, B, S_enc, nH, dh]
        "cross_v": xv,
        "enc_mask": jnp.where(
            jnp.arange(enc_hidden.shape[1])[None, :] < enc_lengths[:, None],
            0.0, MASK_VALUE,
        ),  # [B, S_enc]
    }


@functools.partial(jax.jit, static_argnames=("config",))
def decode_step(config: T5Config, params, state, tokens, pos):
    """One incremental decoder step. tokens [B]; pos scalar int32.
    Returns (logits [B, V], state)."""
    nH, dh = config.head_num, config.size_per_head
    S_out = state["self_k"].shape[2]
    dec = params["dec"]
    x = jnp.take(params["embed"], tokens, axis=0)[:, None]  # [B, 1, D]

    k_pos = jnp.arange(S_out)
    bias_row = _pos_bias(
        config, params["dec_rel_bias"], pos[None], k_pos, False
    )[None]  # [1, nH, 1, S_out]
    causal = jnp.where(k_pos <= pos, 0.0, MASK_VALUE)[None, None, None, :]
    self_bias = bias_row + causal
    cross_bias = state["enc_mask"][:, None, None, :]

    def body(carry, l):
        x, state = carry
        lp = _layer_slice(dec, l)
        h = rmsnorm(x, lp["ln1_w"], config.layernorm_eps)
        q = _mh(h, lp["q_w"], nH, dh)
        k = _mh(h, lp["k_w"], nH, dh)
        v = _mh(h, lp["v_w"], nH, dh)
        sk = jax.lax.dynamic_update_slice(
            state["self_k"], k[None], (l, 0, pos, 0, 0)
        )
        sv = jax.lax.dynamic_update_slice(
            state["self_v"], v[None], (l, 0, pos, 0, 0)
        )
        state = dict(state, self_k=sk, self_v=sv)
        a = _attn(q, sk[l], sv[l], self_bias, lp["o_w"])
        x1 = x + a
        hx = rmsnorm(x1, lp["ln_x_w"], config.layernorm_eps)
        ca = _attn(
            _mh(hx, lp["xq_w"], nH, dh), state["cross_k"][l],
            state["cross_v"][l], cross_bias, lp["xo_w"],
        )
        x2 = x1 + ca
        h2 = rmsnorm(x2, lp["ln2_w"], config.layernorm_eps)
        f = apply_act(_dot2(h2, lp["wi"], "bsd,df->bsf"), config.activation)
        f = _dot2(f, lp["wo"], "bsf,fd->bsd")
        return (x2 + f, state), None

    (x, state), _ = jax.lax.scan(
        body, (x, state), jnp.arange(config.dec_layer_num)
    )
    h = rmsnorm(x[:, 0], params["dec_final_ln_w"], config.layernorm_eps)
    if config.tie_head:
        h = h * (config.d_model ** -0.5)  # HF's tied-embedding rescale
        w = params["embed"]
    else:
        w = params["lm_head"]
    logits = jnp.einsum("bd,vd->bv", h.astype(jnp.float32),
                        w.astype(jnp.float32))
    return logits, state


def greedy_generate(
    config: T5Config, params, input_ids, lengths, max_out: int
):
    """Encoder pass + incremental greedy decode. Returns [B, max_out] int32
    (end_id-padded after EOS)."""
    enc = encode(config, params, input_ids, lengths)
    state = init_decoder_state(config, params, enc, lengths, max_out + 1)
    B = input_ids.shape[0]
    tok = jnp.full((B,), config.start_id, jnp.int32)
    outs = []
    finished = np.zeros((B,), bool)
    for t in range(max_out):
        logits, state = decode_step(config, params, state, tok, jnp.int32(t))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        step = np.asarray(tok)
        step = np.where(finished, config.end_id, step)
        outs.append(step)
        finished |= step == config.end_id
        if finished.all():
            break
        tok = jnp.asarray(step)
    return np.stack(outs, axis=1)


# ------------------------------------------------------------ int8 weights --

_GEMM_NAMES = ("q_w", "k_w", "v_w", "o_w", "xq_w", "xk_w", "xv_w", "xo_w",
               "wi", "wo")


def quantize_t5_params(params):
    """Per-output-channel symmetric int8 on every stacked GEMM weight
    ([L, K, N], k_axis=-2) of both stacks — the weight set the reference's
    T5 engine quantizes nowhere (its t5 path is fp only; this reuses the
    int8_mode=1 math of WeightOnlyQuantOps.cc on the T5 family). Norm
    affines, relative-bias tables, and embeddings stay fp, like the
    CodeFuse-path quantizer (codefuse_example.py:273-285)."""
    from ..ckpt.quantize import quantize_array

    out = dict(params)
    for stack in ("enc", "dec"):
        out[stack] = {
            k: (quantize_array(v, k_axis=-2) if k in _GEMM_NAMES else v)
            for k, v in params[stack].items()
        }
    return out


# ------------------------------------------------------------ TP sharding --


def t5_param_shardings(config: T5Config, params, mesh):
    """NamedSharding pytree: column-split q/k/v (+cross q/k/v) and ffn-up
    over "tp", row-split o/cross-o and ffn-down — the reference's T5 TP
    layout (T5Decoder.cc TensorParallel attention/ffn wrappers), expressed
    as GSPMD PartitionSpecs like parallel/sharding.py does for the decoder
    families. Relative-bias tables split their head axis; embeddings and
    norms replicate."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .params import QuantizedTensor

    COL = P(None, None, "tp")  # [L, K, N] split N
    ROW = P(None, "tp", None)  # [L, K, N] split K
    SPECS = {
        "q_w": COL, "k_w": COL, "v_w": COL, "xq_w": COL, "xk_w": COL,
        "xv_w": COL, "wi": COL, "o_w": ROW, "xo_w": ROW, "wo": ROW,
    }

    def leaf(name, v):
        spec = SPECS.get(name, P())
        if isinstance(v, QuantizedTensor):
            # scale = shape minus the K axis (axis 1 of [L, K, N])
            s_spec = P(*(a for i, a in enumerate(spec) if i != 1))
            return QuantizedTensor(
                q=NamedSharding(mesh, spec),
                scale=NamedSharding(mesh, s_spec),
                k_axis=v.k_axis, bits=v.bits, group_size=v.group_size,
            )
        return NamedSharding(mesh, spec)

    out = {}
    for k, v in params.items():
        if k in ("enc", "dec"):
            out[k] = {n: leaf(n, val) for n, val in v.items()}
        elif k in ("enc_rel_bias", "dec_rel_bias"):
            out[k] = NamedSharding(mesh, P(None, "tp"))  # [buckets, nH]
        else:
            out[k] = NamedSharding(mesh, P())
    return out


def shard_t5_params(config: T5Config, params, mesh):
    from .params import QuantizedTensor

    shardings = t5_param_shardings(config, params, mesh)

    def place(x, s):
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(
                q=jax.device_put(x.q, s.q),
                scale=jax.device_put(x.scale, s.scale),
                k_axis=x.k_axis, bits=x.bits, group_size=x.group_size,
            )
        return jax.device_put(x, s)

    out = {}
    for k, v in params.items():
        if k in ("enc", "dec"):
            out[k] = {n: place(val, shardings[k][n]) for n, val in v.items()}
        else:
            out[k] = place(v, shardings[k])
    return out
