"""ViT encoder family — patch-embedding vision transformer.

The reference ships ViT as its own C++ engine with an int8 variant and a
TensorRT plugin (/root/reference/src/fastertransformer/models/vit/
ViTTransformer.cc, models/vit_int8/, tensorrt_plugin/vit/); it is the first
NON-TEXT family here — the input is pixels, the "tokens" are image patches:

  - patch embedding: a stride-P PxP conv == one reshape + GEMM (the
    tensor-core-friendly formulation; XLA lowers a stride-P conv the same way, but
    the reshape form keeps the weight a plain [P*P*C, H] matrix that rides
    ops/linear like every other projection, int8-ready);
  - learned [CLS] token prepended + learned absolute position embeddings;
  - PRE-LN blocks (x + attn(LN(x)), x + mlp(LN(x))) — the opposite ordering
    of BERT's post-LN — with a final LayerNorm;
  - optional tanh pooler over [CLS].

No attention mask (every patch attends every patch — images have no
padding), so the blocks ride the plain XLA fused attention path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layernorm import layernorm
from ..ops.linear import linear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    image_size: int
    patch_size: int
    num_channels: int = 3
    inter_size: Optional[int] = None
    layernorm_eps: float = 1e-12
    activation: str = "gelu"
    model_name: str = "vit"

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def config_from_hf_vit(hf_config, model_name="vit") -> ViTConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)
    nH = g("num_attention_heads")
    H = g("hidden_size")
    return ViTConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        image_size=g("image_size"),
        patch_size=g("patch_size"),
        num_channels=g("num_channels", 3),
        inter_size=g("intermediate_size"),
        layernorm_eps=float(g("layer_norm_eps", 1e-12)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh",
                    "relu": "relu"}.get(g("hidden_act", "gelu"), "gelu"),
        model_name=model_name,
    )


def params_from_hf_vit_state_dict(
    config: ViTConfig, state_dict: Mapping[str, Any], dtype=jnp.float32
) -> Dict[str, Any]:
    from ..ckpt.convert import _np, stack_layers

    sd = dict(state_dict)
    pre = "vit." if "vit.embeddings.cls_token" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    L = config.layer_num

    def stack(fn):
        return stack_layers(fn, L, dtype)

    def fused_qkv(i):
        a = f"encoder.layer.{i}.attention.attention."
        return np.concatenate(
            [get(a + "query.weight").T, get(a + "key.weight").T,
             get(a + "value.weight").T], axis=1,
        )

    def fused_qkv_b(i):
        a = f"encoder.layer.{i}.attention.attention."
        return np.concatenate(
            [get(a + "query.bias"), get(a + "key.bias"), get(a + "value.bias")]
        )

    layers = {
        "ln1_w": stack(lambda i: get(f"encoder.layer.{i}.layernorm_before.weight")),
        "ln1_b": stack(lambda i: get(f"encoder.layer.{i}.layernorm_before.bias")),
        "qkv_w": stack(fused_qkv),
        "qkv_b": stack(fused_qkv_b),
        "proj_w": stack(lambda i: get(f"encoder.layer.{i}.attention.output.dense.weight").T),
        "proj_b": stack(lambda i: get(f"encoder.layer.{i}.attention.output.dense.bias")),
        "ln2_w": stack(lambda i: get(f"encoder.layer.{i}.layernorm_after.weight")),
        "ln2_b": stack(lambda i: get(f"encoder.layer.{i}.layernorm_after.bias")),
        "up_w": stack(lambda i: get(f"encoder.layer.{i}.intermediate.dense.weight").T),
        "up_b": stack(lambda i: get(f"encoder.layer.{i}.intermediate.dense.bias")),
        "down_w": stack(lambda i: get(f"encoder.layer.{i}.output.dense.weight").T),
        "down_b": stack(lambda i: get(f"encoder.layer.{i}.output.dense.bias")),
    }
    # stride-P conv [H, C, P, P] -> patch GEMM [P*P*C, H]: the patch pixels
    # flatten (C, ph, pw) row-major to match the conv's contraction order
    conv_w = get("embeddings.patch_embeddings.projection.weight")
    H = conv_w.shape[0]
    patch_w = conv_w.reshape(H, -1).T  # [(C*P*P), H]
    out = {
        "cls": jnp.asarray(get("embeddings.cls_token")[0, 0], dtype),  # [H]
        "pos_embed": jnp.asarray(get("embeddings.position_embeddings")[0], dtype),
        "patch_w": jnp.asarray(patch_w, dtype),
        "patch_b": jnp.asarray(get("embeddings.patch_embeddings.projection.bias"), dtype),
        "final_ln_w": jnp.asarray(get("layernorm.weight"), dtype),
        "final_ln_b": jnp.asarray(get("layernorm.bias"), dtype),
        "layers": layers,
    }
    if pre + "pooler.dense.weight" in sd:
        out["pooler_w"] = jnp.asarray(get("pooler.dense.weight").T, dtype)
        out["pooler_b"] = jnp.asarray(get("pooler.dense.bias"), dtype)
    return out


def patchify(config: ViTConfig, pixels: jax.Array) -> jax.Array:
    """[B, C, H, W] -> [B, nP, C*P*P] (channel-major per patch, the conv's
    contraction order)."""
    B, C, Hh, Ww = pixels.shape
    P = config.patch_size
    x = pixels.reshape(B, C, Hh // P, P, Ww // P, P)
    x = x.transpose(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, P, P]
    return x.reshape(B, (Hh // P) * (Ww // P), C * P * P)


def encode(config: ViTConfig, params: Dict[str, Any], pixels: jax.Array):
    """Full ViT pass. pixels [B, C, H, W] -> (hidden [B, 1+nP, H], pooled)."""
    from .params import layer_slice

    B = pixels.shape[0]
    x = linear(patchify(config, pixels), params["patch_w"], params["patch_b"])
    cls = jnp.broadcast_to(params["cls"][None, None, :], (B, 1, x.shape[-1]))
    x = jnp.concatenate([cls.astype(x.dtype), x], axis=1)
    x = x + params["pos_embed"][None, : x.shape[1]]

    nH, dh = config.head_num, config.size_per_head
    layers = params["layers"]

    def body(carry, l):
        lp = layer_slice(layers, l)
        h = layernorm(carry, lp["ln1_w"], lp["ln1_b"], config.layernorm_eps)
        S, Hd = h.shape[1], h.shape[2]
        qkv = linear(h, lp["qkv_w"], lp["qkv_b"])
        q = qkv[..., :Hd].reshape(B, S, nH, dh)
        k = qkv[..., Hd: 2 * Hd].reshape(B, S, nH, dh)
        v = qkv[..., 2 * Hd:].reshape(B, S, nH, dh)
        scores = jnp.einsum(
            "bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32
        ) / (dh ** 0.5)
        probs = jax.nn.softmax(scores, axis=-1).astype(h.dtype)
        a = jnp.einsum(
            "bhqk,bkhd->bqhd", probs, v, preferred_element_type=jnp.float32
        ).astype(h.dtype).reshape(B, S, Hd)
        a = linear(a, lp["proj_w"], lp["proj_b"])
        x1 = carry + a  # pre-LN residual
        h2 = layernorm(x1, lp["ln2_w"], lp["ln2_b"], config.layernorm_eps)
        f = linear(h2, lp["up_w"], lp["up_b"], act=config.activation)
        f = linear(f, lp["down_w"], lp["down_b"])
        return x1 + f, None

    x, _ = jax.lax.scan(body, x, jnp.arange(config.layer_num))
    x = layernorm(x, params["final_ln_w"], params["final_ln_b"],
                  config.layernorm_eps)
    pooled = None
    if "pooler_w" in params:
        pooled = jnp.tanh(linear(x[:, 0], params["pooler_w"], params["pooler_b"]))
    return x, pooled
