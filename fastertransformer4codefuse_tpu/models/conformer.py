"""Conformer audio-encoder family — the reference's `wenet` model class.

The reference serves WeNet's Conformer ASR encoder as its own C++ engine
(/root/reference/src/fastertransformer/models/wenet/WenetEncoder.cc +
kernels/wenet_kernels.cu). The Conformer block is the distinctive pattern:
half-step macaron FFNs sandwiching Transformer-XL-style relative attention
AND a convolution module (pointwise→GLU→depthwise→batchnorm→act→pointwise)
— the first family here mixing attention with convolutions. Parity oracle:
HF Wav2Vec2ConformerModel with position_embeddings_type="relative" (the
same ESPnet conformer math WeNet uses), including its raw-audio feature
extractor (strided 1D convs + per-channel GroupNorm) so the parity covers
waveform → hidden end to end.

Convolutions lower through jax.lax.conv_general_dilated — XLA maps strided
and depthwise 1D convs onto the MXU/VPU directly (the reference hand-writes
cuDNN-adjacent kernels for these in wenet_kernels.cu).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layernorm import layernorm
from ..ops.linear import linear
from ..ops.linear import apply_act


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    inter_size: int
    conv_dim: Tuple[int, ...]
    conv_stride: Tuple[int, ...]
    conv_kernel: Tuple[int, ...]
    depthwise_kernel: int = 31
    layernorm_eps: float = 1e-5
    activation: str = "gelu"
    feat_activation: str = "gelu"
    model_name: str = "conformer"

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head


def config_from_hf_conformer(hf_config, model_name="conformer") -> ConformerConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)
    assert g("position_embeddings_type") == "relative", (
        "conformer family implements the relative-attention variant "
        "(the WeNet/ESPnet form)"
    )
    nH = g("num_attention_heads")
    H = g("hidden_size")
    amap = {"gelu": "gelu", "gelu_new": "gelu-tanh", "relu": "relu",
            "swish": "silu", "silu": "silu"}
    return ConformerConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        inter_size=g("intermediate_size"),
        conv_dim=tuple(g("conv_dim")),
        conv_stride=tuple(g("conv_stride")),
        conv_kernel=tuple(g("conv_kernel")),
        depthwise_kernel=g("conv_depthwise_kernel_size", 31),
        layernorm_eps=float(g("layer_norm_eps", 1e-5)),
        activation=amap.get(g("hidden_act", "gelu"), "gelu"),
        feat_activation=amap.get(g("feat_extract_activation", "gelu"), "gelu"),
        model_name=model_name,
    )


def params_from_hf_conformer_state_dict(
    config: ConformerConfig, state_dict: Mapping[str, Any], dtype=jnp.float32
) -> Dict[str, Any]:
    from ..ckpt.convert import _np, stack_layers

    sd = dict(state_dict)
    pre = ("wav2vec2_conformer."
           if "wav2vec2_conformer.feature_projection.projection.weight" in sd
           else "")

    def get(name):
        return _np(sd[pre + name])

    L = config.layer_num

    def stack(fn):
        return stack_layers(fn, L, dtype)

    feat = []
    for li in range(len(config.conv_dim)):
        fl = {"conv_w": jnp.asarray(
            get(f"feature_extractor.conv_layers.{li}.conv.weight"), dtype)}
        if pre + f"feature_extractor.conv_layers.{li}.conv.bias" in sd:
            fl["conv_b"] = jnp.asarray(
                get(f"feature_extractor.conv_layers.{li}.conv.bias"), dtype)
        if pre + f"feature_extractor.conv_layers.{li}.layer_norm.weight" in sd:
            fl["gn_w"] = jnp.asarray(
                get(f"feature_extractor.conv_layers.{li}.layer_norm.weight"), dtype)
            fl["gn_b"] = jnp.asarray(
                get(f"feature_extractor.conv_layers.{li}.layer_norm.bias"), dtype)
        feat.append(fl)

    def ffn(which):
        return {
            f"{which}_ln_w": stack(lambda i: get(f"encoder.layers.{i}.{which}_layer_norm.weight")),
            f"{which}_ln_b": stack(lambda i: get(f"encoder.layers.{i}.{which}_layer_norm.bias")),
            f"{which}_up_w": stack(lambda i: get(f"encoder.layers.{i}.{which}.intermediate_dense.weight").T),
            f"{which}_up_b": stack(lambda i: get(f"encoder.layers.{i}.{which}.intermediate_dense.bias")),
            f"{which}_down_w": stack(lambda i: get(f"encoder.layers.{i}.{which}.output_dense.weight").T),
            f"{which}_down_b": stack(lambda i: get(f"encoder.layers.{i}.{which}.output_dense.bias")),
        }

    layers = {}
    layers.update(ffn("ffn1"))
    layers.update(ffn("ffn2"))
    a = "encoder.layers.{}.self_attn."
    layers.update({
        "attn_ln_w": stack(lambda i: get(f"encoder.layers.{i}.self_attn_layer_norm.weight")),
        "attn_ln_b": stack(lambda i: get(f"encoder.layers.{i}.self_attn_layer_norm.bias")),
        "q_w": stack(lambda i: get(a.format(i) + "linear_q.weight").T),
        "q_b": stack(lambda i: get(a.format(i) + "linear_q.bias")),
        "k_w": stack(lambda i: get(a.format(i) + "linear_k.weight").T),
        "k_b": stack(lambda i: get(a.format(i) + "linear_k.bias")),
        "v_w": stack(lambda i: get(a.format(i) + "linear_v.weight").T),
        "v_b": stack(lambda i: get(a.format(i) + "linear_v.bias")),
        "o_w": stack(lambda i: get(a.format(i) + "linear_out.weight").T),
        "o_b": stack(lambda i: get(a.format(i) + "linear_out.bias")),
        "pos_w": stack(lambda i: get(a.format(i) + "linear_pos.weight").T),
        "bias_u": stack(lambda i: get(a.format(i) + "pos_bias_u")),  # [nH, dh]
        "bias_v": stack(lambda i: get(a.format(i) + "pos_bias_v")),
        "conv_ln_w": stack(lambda i: get(f"encoder.layers.{i}.conv_module.layer_norm.weight")),
        "conv_ln_b": stack(lambda i: get(f"encoder.layers.{i}.conv_module.layer_norm.bias")),
        "pw1_w": stack(lambda i: get(f"encoder.layers.{i}.conv_module.pointwise_conv1.weight")[:, :, 0].T),
        "dw_w": stack(lambda i: get(f"encoder.layers.{i}.conv_module.depthwise_conv.weight")),  # [C, 1, K]
        "bn_w": stack(lambda i: get(f"encoder.layers.{i}.conv_module.batch_norm.weight")),
        "bn_b": stack(lambda i: get(f"encoder.layers.{i}.conv_module.batch_norm.bias")),
        "bn_mean": stack(lambda i: get(f"encoder.layers.{i}.conv_module.batch_norm.running_mean")),
        "bn_var": stack(lambda i: get(f"encoder.layers.{i}.conv_module.batch_norm.running_var")),
        "pw2_w": stack(lambda i: get(f"encoder.layers.{i}.conv_module.pointwise_conv2.weight")[:, :, 0].T),
        "final_ln_w": stack(lambda i: get(f"encoder.layers.{i}.final_layer_norm.weight")),
        "final_ln_b": stack(lambda i: get(f"encoder.layers.{i}.final_layer_norm.bias")),
    })
    return {
        "feat": feat,
        "proj_ln_w": jnp.asarray(get("feature_projection.layer_norm.weight"), dtype),
        "proj_ln_b": jnp.asarray(get("feature_projection.layer_norm.bias"), dtype),
        "proj_w": jnp.asarray(get("feature_projection.projection.weight").T, dtype),
        "proj_b": jnp.asarray(get("feature_projection.projection.bias"), dtype),
        "enc_ln_w": jnp.asarray(get("encoder.layer_norm.weight"), dtype),
        "enc_ln_b": jnp.asarray(get("encoder.layer_norm.bias"), dtype),
        "layers": layers,
    }


def _rel_pos_emb(D: int, S: int) -> jax.Array:
    """ESPnet relative PE: [2S-1, D], positive part reversed then negatives."""
    pos = np.arange(S, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, D, 2, dtype=np.float64) * -(np.log(10000.0) / D))
    pe_pos = np.zeros((S, D))
    pe_neg = np.zeros((S, D))
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    return jnp.asarray(
        np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0), jnp.float32
    )


def feature_extract(config: ConformerConfig, params, audio: jax.Array):
    """Raw audio [B, T] -> features [B, T', conv_dim[-1]] (strided 1D convs,
    per-channel GroupNorm on layer 0, activation)."""
    x = audio[:, None, :]  # [B, 1, T]
    for li, fl in enumerate(params["feat"]):
        w = fl["conv_w"]  # [out, in, K]
        x = jax.lax.conv_general_dilated(
            x, w.astype(x.dtype), (config.conv_stride[li],), "VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
        )
        if "conv_b" in fl:
            x = x + fl["conv_b"][None, :, None]
        if "gn_w" in fl:  # GroupNorm(groups == channels): per-channel over T
            mean = jnp.mean(x, axis=2, keepdims=True)
            var = jnp.var(x, axis=2, keepdims=True)
            x = (x - mean) / jnp.sqrt(var + 1e-5)
            x = x * fl["gn_w"][None, :, None] + fl["gn_b"][None, :, None]
        x = apply_act(x, config.feat_activation)
    return x.transpose(0, 2, 1)  # [B, T', C]


def _conv_module(config, lp, x):
    """LN -> pointwise(2C)+GLU -> depthwise(K, same) -> batchnorm(eval) ->
    act -> pointwise."""
    C = x.shape[-1]
    h = layernorm(x, lp["conv_ln_w"], lp["conv_ln_b"], config.layernorm_eps)
    h = linear(h, lp["pw1_w"])  # [B, S, 2C]
    a, b = h[..., :C], h[..., C:]
    h = a * jax.nn.sigmoid(b)  # GLU over the channel split
    # depthwise: [B, S, C] -> NCH conv with feature_group_count=C
    hh = h.transpose(0, 2, 1)
    K = lp["dw_w"].shape[-1]
    hh = jax.lax.conv_general_dilated(
        hh, lp["dw_w"].astype(hh.dtype), (1,), [((K - 1) // 2, (K - 1) // 2)],
        dimension_numbers=("NCH", "OIH", "NCH"), feature_group_count=C,
    )
    hh = (hh - lp["bn_mean"][None, :, None]) / jnp.sqrt(
        lp["bn_var"][None, :, None] + 1e-5
    )
    hh = hh * lp["bn_w"][None, :, None] + lp["bn_b"][None, :, None]
    hh = apply_act(hh, config.activation)
    return linear(hh.transpose(0, 2, 1), lp["pw2_w"])


def _rel_attention(config, lp, x, pe):
    """Transformer-XL attention with pos_bias_u/v and the ESPnet shift."""
    B, S, H = x.shape
    nH, dh = config.head_num, config.size_per_head
    q = linear(x, lp["q_w"], lp["q_b"]).reshape(B, S, nH, dh)
    k = linear(x, lp["k_w"], lp["k_b"]).reshape(B, S, nH, dh)
    v = linear(x, lp["v_w"], lp["v_b"]).reshape(B, S, nH, dh)
    p = linear(pe[None], lp["pos_w"]).reshape(1, 2 * S - 1, nH, dh)

    ac = jnp.einsum("bihd,bjhd->bhij", q + lp["bias_u"][None, None], k,
                    preferred_element_type=jnp.float32)
    bd = jnp.einsum("bihd,bjhd->bhij", q + lp["bias_v"][None, None],
                    jnp.broadcast_to(p, (B, 2 * S - 1, nH, dh)),
                    preferred_element_type=jnp.float32)  # [B, nH, S, 2S-1]
    # ESPnet shift: zero-pad last dim, reshape, drop, take first S columns
    zp = jnp.zeros(bd.shape[:3] + (1,), bd.dtype)
    pad = jnp.concatenate([zp, bd], axis=-1)  # [B, nH, S, 2S]
    pad = pad.reshape(B, nH, 2 * S, S)[:, :, 1:]
    bd = pad.reshape(B, nH, S, 2 * S - 1)[:, :, :, :S]
    scores = (ac + bd) / (dh ** 0.5)
    probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    ctx = jnp.einsum("bhij,bjhd->bihd", probs, v,
                     preferred_element_type=jnp.float32).astype(x.dtype)
    return linear(ctx.reshape(B, S, H), lp["o_w"], lp["o_b"])


def encode(config: ConformerConfig, params: Dict[str, Any], audio: jax.Array):
    """Raw audio [B, T] -> (hidden [B, T', H], None)."""
    from .params import layer_slice

    feats = feature_extract(config, params, audio)
    x = layernorm(feats, params["proj_ln_w"], params["proj_ln_b"],
                  config.layernorm_eps)
    x = linear(x, params["proj_w"], params["proj_b"])
    S = x.shape[1]
    pe = _rel_pos_emb(config.hidden_size, S)

    def ffn_half(lp, x, which):
        h = layernorm(x, lp[f"{which}_ln_w"], lp[f"{which}_ln_b"],
                      config.layernorm_eps)
        h = linear(h, lp[f"{which}_up_w"], lp[f"{which}_up_b"],
                   act=config.activation)
        h = linear(h, lp[f"{which}_down_w"], lp[f"{which}_down_b"])
        return x + 0.5 * h

    layers = params["layers"]

    def body(carry, l):
        lp = layer_slice(layers, l)
        x = ffn_half(lp, carry, "ffn1")
        h = layernorm(x, lp["attn_ln_w"], lp["attn_ln_b"], config.layernorm_eps)
        x = x + _rel_attention(config, lp, h, pe)
        x = x + _conv_module(config, lp, x)
        x = ffn_half(lp, x, "ffn2")
        return layernorm(x, lp["final_ln_w"], lp["final_ln_b"],
                         config.layernorm_eps), None

    x, _ = jax.lax.scan(body, x, jnp.arange(config.layer_num))
    return layernorm(x, params["enc_ln_w"], params["enc_ln_b"],
                     config.layernorm_eps), None
