"""XLNet encoder family — Transformer-XL relative attention.

The reference ships XLNet as its own C++ engine
(/root/reference/src/fastertransformer/models/xlnet/Xlnet.cc +
kernels/xlnet_*_kernels.cu); fifth distinct attention pattern through the
kernel seam: scores are the Transformer-XL sum of a content term (q+r_w_bias
vs keys), a RELATIVE-POSITION term (q+r_r_bias vs sinusoid-projected
positions, realigned per-row by the rel-shift trick), and an optional
SEGMENT term (q+r_s_bias vs the learned same/other-segment embeddings).
Post-LN blocks.

Scope matches the reference's xlnet engine: the no-permutation inference
path (content stream only — the g-stream/target-mapping machinery exists for
permutation-LM TRAINING, which the reference does not serve either). Parity
oracle: HF XLNetModel (attn_type "bi", use_mems=False), including its
padding semantics (the -1e30 additive mask with the unmasked diagonal).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layernorm import layernorm
from ..ops.linear import linear
from ..ops.linear import apply_act


@dataclasses.dataclass(frozen=True)
class XLNetConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    inter_size: int
    layernorm_eps: float = 1e-12
    activation: str = "gelu"
    clamp_len: int = -1
    model_name: str = "xlnet"

    @property
    def d_model(self) -> int:
        return self.head_num * self.size_per_head


def config_from_hf_xlnet(hf_config, model_name="xlnet") -> XLNetConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)
    return XLNetConfig(
        head_num=g("n_head"),
        size_per_head=g("d_head"),
        layer_num=g("n_layer"),
        vocab_size=g("vocab_size"),
        inter_size=g("d_inner"),
        layernorm_eps=float(g("layer_norm_eps", 1e-12)),
        activation={"gelu": "gelu", "relu": "relu"}.get(g("ff_activation", "gelu"), "gelu"),
        clamp_len=int(g("clamp_len", -1)),
        model_name=model_name,
    )


def params_from_hf_xlnet_state_dict(
    config: XLNetConfig, state_dict: Mapping[str, Any], dtype=jnp.float32
) -> Dict[str, Any]:
    from ..ckpt.convert import _np, stack_layers

    sd = dict(state_dict)
    pre = "transformer." if "transformer.word_embedding.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    L = config.layer_num

    def stack(fn):
        return stack_layers(fn, L, dtype)

    layers = {
        # attention projections are stored [d_model, nH, dh]
        "q": stack(lambda i: get(f"layer.{i}.rel_attn.q")),
        "k": stack(lambda i: get(f"layer.{i}.rel_attn.k")),
        "v": stack(lambda i: get(f"layer.{i}.rel_attn.v")),
        "o": stack(lambda i: get(f"layer.{i}.rel_attn.o")),  # [d_model, nH, dh]
        "r": stack(lambda i: get(f"layer.{i}.rel_attn.r")),
        "r_w_bias": stack(lambda i: get(f"layer.{i}.rel_attn.r_w_bias")),  # [nH, dh]
        "r_r_bias": stack(lambda i: get(f"layer.{i}.rel_attn.r_r_bias")),
        "r_s_bias": stack(lambda i: get(f"layer.{i}.rel_attn.r_s_bias")),
        "seg_embed": stack(lambda i: get(f"layer.{i}.rel_attn.seg_embed")),  # [2, nH, dh]
        "attn_ln_w": stack(lambda i: get(f"layer.{i}.rel_attn.layer_norm.weight")),
        "attn_ln_b": stack(lambda i: get(f"layer.{i}.rel_attn.layer_norm.bias")),
        "ff1_w": stack(lambda i: get(f"layer.{i}.ff.layer_1.weight").T),
        "ff1_b": stack(lambda i: get(f"layer.{i}.ff.layer_1.bias")),
        "ff2_w": stack(lambda i: get(f"layer.{i}.ff.layer_2.weight").T),
        "ff2_b": stack(lambda i: get(f"layer.{i}.ff.layer_2.bias")),
        "ff_ln_w": stack(lambda i: get(f"layer.{i}.ff.layer_norm.weight")),
        "ff_ln_b": stack(lambda i: get(f"layer.{i}.ff.layer_norm.bias")),
    }
    return {
        "embed": jnp.asarray(get("word_embedding.weight"), dtype),
        "layers": layers,
    }


def _pos_emb(config: XLNetConfig, S: int) -> jax.Array:
    """Sinusoid relative-position embeddings for attn_type="bi":
    positions klen..(-qlen+1) descending -> [2S, d_model]."""
    D = config.d_model
    freq = np.arange(0, D, 2.0, dtype=np.float64)
    inv = 1.0 / np.power(10000.0, freq / D)
    pos = np.arange(S, -S, -1.0, dtype=np.float64)
    if config.clamp_len > 0:
        pos = np.clip(pos, -config.clamp_len, config.clamp_len)
    sin = np.einsum("i,d->id", pos, inv)
    return jnp.asarray(
        np.concatenate([np.sin(sin), np.cos(sin)], axis=-1), jnp.float32
    )


def _rel_shift(x: jax.Array, klen: int) -> jax.Array:
    """HF rel_shift_bnij: [B, N, I, J] realignment."""
    B, N, I, J = x.shape
    x = x.reshape(B, N, J, I)[:, :, 1:, :].reshape(B, N, I, J - 1)
    return x[:, :, :, :klen]


def encode(
    config: XLNetConfig,
    params: Dict[str, Any],
    input_ids: jax.Array,  # [B, S] int32
    lengths: jax.Array,  # [B]
    token_type_ids: Optional[jax.Array] = None,
):
    """Content-stream forward -> (last_hidden [B, S, D], None)."""
    from .params import layer_slice

    B, S = input_ids.shape
    nH, dh = config.head_num, config.size_per_head
    scale = 1.0 / (dh ** 0.5)
    x = jnp.take(params["embed"], input_ids, axis=0)  # [B, S, D]
    r = _pos_emb(config, S)  # [2S, D]

    real = jnp.arange(S)[None, :] < lengths[:, None]  # [B, S]
    # HF padding semantics: additive -1e30 on padded KEYS, with the diagonal
    # re-opened (non_tgt_mask's -eye) so a padded row still attends itself
    masked_kj = (~real)[:, None, :]  # [B, 1(i), S(j)]
    eye = jnp.eye(S, dtype=bool)[None]
    attn_mask = jnp.where(masked_kj & ~eye, 1.0, 0.0)[:, None]  # [B, 1, S?, S]

    if token_type_ids is not None:
        seg_diff = (token_type_ids[:, :, None] != token_type_ids[:, None, :])
        seg_onehot = jax.nn.one_hot(seg_diff.astype(jnp.int32), 2)  # [B,i,j,2]
    else:
        seg_onehot = None

    layers = params["layers"]
    for l in range(config.layer_num):
        lp = layer_slice(layers, l)
        q = jnp.einsum("bih,hnd->bind", x, lp["q"].astype(x.dtype))
        k = jnp.einsum("bih,hnd->bind", x, lp["k"].astype(x.dtype))
        v = jnp.einsum("bih,hnd->bind", x, lp["v"].astype(x.dtype))
        kr = jnp.einsum("jh,hnd->jnd", r.astype(x.dtype), lp["r"].astype(x.dtype))

        ac = jnp.einsum("bind,bjnd->bnij", q + lp["r_w_bias"], k,
                        preferred_element_type=jnp.float32)
        bd = jnp.einsum("bind,jnd->bnij", q + lp["r_r_bias"], kr,
                        preferred_element_type=jnp.float32)
        bd = _rel_shift(bd, klen=S)
        score = ac + bd
        if seg_onehot is not None:
            ef = jnp.einsum("bind,snd->bins", q + lp["r_s_bias"],
                            lp["seg_embed"].astype(x.dtype),
                            preferred_element_type=jnp.float32)
            score = score + jnp.einsum("bijs,bins->bnij",
                                       seg_onehot.astype(jnp.float32), ef)
        score = score * scale - 1e30 * attn_mask
        probs = jax.nn.softmax(score, axis=-1).astype(x.dtype)
        av = jnp.einsum("bnij,bjnd->bind", probs, v,
                        preferred_element_type=jnp.float32).astype(x.dtype)
        attn_out = jnp.einsum("bind,hnd->bih", av, lp["o"].astype(x.dtype),
                              preferred_element_type=jnp.float32).astype(x.dtype)
        x = layernorm(attn_out + x, lp["attn_ln_w"], lp["attn_ln_b"],
                      config.layernorm_eps)
        f = apply_act(linear(x, lp["ff1_w"], lp["ff1_b"]), config.activation)
        f = linear(f, lp["ff2_w"], lp["ff2_b"])
        x = layernorm(f + x, lp["ff_ln_w"], lp["ff_ln_b"], config.layernorm_eps)
    return x, None
