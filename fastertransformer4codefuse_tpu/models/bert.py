"""BERT encoder family — the reference's `bert` model class.

The reference serves BERT through its own C++ engine
(/root/reference/src/fastertransformer/models/bert/Bert.cc — fused
self-attention + post-LayerNorm FFN blocks); a code-serving platform uses it
for embeddings / retrieval / classification next to the generative models.
This module is the encoder analog of models/gptneox.py:

  - POST-LayerNorm residuals (h = LN(x + attn), out = LN(h + ffn)) — the
    original BERT ordering, different from every decoder family here;
  - BIDIRECTIONAL attention (padding-masked, no causal mask, no KV cache —
    a single fused prefill-style pass);
  - learned absolute positions + token-type (segment) embeddings + an
    embedding LayerNorm;
  - tanh pooler over [CLS] (HF BertPooler).

Everything rides the same ops layer (linear/layernorm + XLA-fused
attention); the layer stack is one `lax.scan` like the decoder families.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layernorm import layernorm
from ..ops.linear import linear

MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    max_position_embeddings: int
    type_vocab_size: int = 2
    inter_size: Optional[int] = None
    layernorm_eps: float = 1e-12
    activation: str = "gelu"
    model_name: str = "bert"

    def __post_init__(self):
        if self.inter_size is None:
            object.__setattr__(self, "inter_size", 4 * self.hidden_size)

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head


def config_from_hf_bert(hf_config, model_name: str = "bert") -> BertConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)
    nH = g("num_attention_heads")
    H = g("hidden_size")
    return BertConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        vocab_size=g("vocab_size"),
        max_position_embeddings=g("max_position_embeddings"),
        type_vocab_size=g("type_vocab_size", 2),
        inter_size=g("intermediate_size"),
        layernorm_eps=float(g("layer_norm_eps", 1e-12)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh",
                    "relu": "relu"}.get(g("hidden_act", "gelu"), "gelu"),
        model_name=model_name,
    )


def params_from_hf_bert_state_dict(
    config: BertConfig, state_dict: Mapping[str, Any], dtype=jnp.float32
) -> Dict[str, Any]:
    from ..ckpt.convert import _np

    sd = dict(state_dict)
    pre = "bert." if "bert.embeddings.word_embeddings.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    L = config.layer_num

    def stack(fn):
        from ..ckpt.convert import stack_layers

        return stack_layers(fn, L, dtype)

    def fused_qkv(i):
        a = f"encoder.layer.{i}.attention.self."
        return np.concatenate(
            [get(a + "query.weight").T, get(a + "key.weight").T,
             get(a + "value.weight").T], axis=1,
        )

    def fused_qkv_b(i):
        a = f"encoder.layer.{i}.attention.self."
        return np.concatenate(
            [get(a + "query.bias"), get(a + "key.bias"), get(a + "value.bias")]
        )

    layers = {
        "qkv_w": stack(fused_qkv),
        "qkv_b": stack(fused_qkv_b),
        "proj_w": stack(
            lambda i: get(f"encoder.layer.{i}.attention.output.dense.weight").T
        ),
        "proj_b": stack(
            lambda i: get(f"encoder.layer.{i}.attention.output.dense.bias")
        ),
        "attn_ln_w": stack(
            lambda i: get(f"encoder.layer.{i}.attention.output.LayerNorm.weight")
        ),
        "attn_ln_b": stack(
            lambda i: get(f"encoder.layer.{i}.attention.output.LayerNorm.bias")
        ),
        "up_w": stack(lambda i: get(f"encoder.layer.{i}.intermediate.dense.weight").T),
        "up_b": stack(lambda i: get(f"encoder.layer.{i}.intermediate.dense.bias")),
        "down_w": stack(lambda i: get(f"encoder.layer.{i}.output.dense.weight").T),
        "down_b": stack(lambda i: get(f"encoder.layer.{i}.output.dense.bias")),
        "out_ln_w": stack(lambda i: get(f"encoder.layer.{i}.output.LayerNorm.weight")),
        "out_ln_b": stack(lambda i: get(f"encoder.layer.{i}.output.LayerNorm.bias")),
    }
    out = {
        "embed": jnp.asarray(get("embeddings.word_embeddings.weight"), dtype),
        "pos_embed": jnp.asarray(
            get("embeddings.position_embeddings.weight"), dtype
        ),
        "type_embed": jnp.asarray(
            get("embeddings.token_type_embeddings.weight"), dtype
        ),
        "embed_ln_w": jnp.asarray(get("embeddings.LayerNorm.weight"), dtype),
        "embed_ln_b": jnp.asarray(get("embeddings.LayerNorm.bias"), dtype),
        "layers": layers,
    }
    if pre + "pooler.dense.weight" in sd:
        out["pooler_w"] = jnp.asarray(get("pooler.dense.weight").T, dtype)
        out["pooler_b"] = jnp.asarray(get("pooler.dense.bias"), dtype)
    return out


def _block(config: BertConfig, lp, x, mask):
    """One post-LN encoder block. x [B, S, H]; mask [B, 1, 1, S] additive."""
    B, S, H = x.shape
    nH, dh = config.head_num, config.size_per_head
    qkv = linear(x, lp["qkv_w"], lp["qkv_b"])  # [B, S, 3H]
    q = qkv[..., :H].reshape(B, S, nH, dh)
    k = qkv[..., H: 2 * H].reshape(B, S, nH, dh)
    v = qkv[..., 2 * H:].reshape(B, S, nH, dh)
    scores = jnp.einsum(
        "bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32
    ) / (dh ** 0.5)
    scores = scores + mask
    probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    attn = jnp.einsum(
        "bhqk,bkhd->bqhd", probs, v, preferred_element_type=jnp.float32
    ).astype(x.dtype)
    attn = linear(attn.reshape(B, S, H), lp["proj_w"], lp["proj_b"])
    h = layernorm(
        x + attn, lp["attn_ln_w"], lp["attn_ln_b"], config.layernorm_eps
    )
    ffn = linear(h, lp["up_w"], lp["up_b"], act=config.activation)
    ffn = linear(ffn, lp["down_w"], lp["down_b"])
    return layernorm(
        h + ffn, lp["out_ln_w"], lp["out_ln_b"], config.layernorm_eps
    )


def encode(
    config: BertConfig,
    params: Dict[str, Any],
    input_ids: jax.Array,  # [B, S] int32
    lengths: jax.Array,  # [B] — padding mask
    token_type_ids: Optional[jax.Array] = None,  # [B, S]
):
    """Full encoder pass. Returns (last_hidden [B, S, H], pooled [B, H] or
    None). Bidirectional: every real token attends every real token."""
    B, S = input_ids.shape
    x = jnp.take(params["embed"], input_ids, axis=0)
    x = x + params["pos_embed"][None, :S]
    tt = (
        jnp.zeros((B, S), jnp.int32) if token_type_ids is None else token_type_ids
    )
    x = x + jnp.take(params["type_embed"], tt, axis=0)
    x = layernorm(
        x, params["embed_ln_w"], params["embed_ln_b"], config.layernorm_eps
    )

    pad = jnp.arange(S)[None, :] < lengths[:, None]  # [B, S]
    mask = jnp.where(pad, 0.0, MASK_VALUE)[:, None, None, :]  # keys masked

    layers = params["layers"]

    def body(carry, l):
        from .params import layer_slice

        return _block(config, layer_slice(layers, l), carry, mask), None

    x, _ = jax.lax.scan(body, x, jnp.arange(config.layer_num))

    pooled = None
    if "pooler_w" in params:
        pooled = jnp.tanh(
            linear(x[:, 0], params["pooler_w"], params["pooler_b"])
        )
    return x, pooled


# ----------------------------------------------- int8 weights / TP / engine --

_GEMM_NAMES = ("qkv_w", "proj_w", "up_w", "down_w")


def quantize_bert_params(params):
    """Per-output-channel int8 on the four GEMM weights per layer — the
    reference ships this as its own engine variant
    (/root/reference/src/fastertransformer/models/bert_int8/BertINT8.cc +
    layers/attention_layers_int8); here it is the same quantize_array math
    the decoder families use. Embeddings/LN/pooler stay fp."""
    from ..ckpt.quantize import quantize_array

    out = dict(params)
    out["layers"] = {
        k: (quantize_array(v, k_axis=-2) if k in _GEMM_NAMES else v)
        for k, v in params["layers"].items()
    }
    return out


def bert_param_shardings(config: BertConfig, params, mesh):
    """TP PartitionSpecs: column-split fused QKV and ffn-up, row-split proj
    and ffn-down (the reference's TensorParallel Bert layers); embeddings,
    norms, and the pooler replicate."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .params import QuantizedTensor

    SPECS = {
        "qkv_w": P(None, None, "tp"), "qkv_b": P(None, "tp"),
        "proj_w": P(None, "tp", None),
        "up_w": P(None, None, "tp"), "up_b": P(None, "tp"),
        "down_w": P(None, "tp", None),
    }

    def leaf(name, v):
        spec = SPECS.get(name, P())
        if isinstance(v, QuantizedTensor):
            s_spec = P(*(a for i, a in enumerate(spec) if i != 1))
            return QuantizedTensor(
                q=NamedSharding(mesh, spec),
                scale=NamedSharding(mesh, s_spec),
                k_axis=v.k_axis, bits=v.bits, group_size=v.group_size,
            )
        return NamedSharding(mesh, spec)

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {n: leaf(n, val) for n, val in v.items()}
        else:
            out[k] = NamedSharding(mesh, P())
    return out


def shard_bert_params(config: BertConfig, params, mesh):
    from .params import QuantizedTensor

    shardings = bert_param_shardings(config, params, mesh)

    def place(x, s):
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(
                q=jax.device_put(x.q, s.q), scale=jax.device_put(x.scale, s.scale),
                k_axis=x.k_axis, bits=x.bits, group_size=x.group_size,
            )
        return jax.device_put(x, s)

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {n: place(val, shardings[k][n]) for n, val in v.items()}
        else:
            out[k] = place(v, shardings[k])
    return out


class BertEngine:
    """Served-encoder seam (registry make_engine): holds (optionally
    TP-sharded, optionally int8) params and a jitted encode — the analog of
    the reference's BertTritonModel instance
    (triton_backend/bert/BertTritonModel.cc)."""

    def __init__(self, config: BertConfig, params, mesh=None):
        self.config = config
        self.params = (
            shard_bert_params(config, params, mesh) if mesh is not None else params
        )
        import functools

        self._encode = jax.jit(
            functools.partial(encode, config), static_argnames=()
        )

    def encode(self, input_ids, lengths, token_type_ids=None):
        return self._encode(
            self.params, jnp.asarray(input_ids), jnp.asarray(lengths),
            token_type_ids if token_type_ids is None else jnp.asarray(token_type_ids),
        )
