"""Parameter pytrees for GPT-NeoX models.

Replacement for the reference's host-side weight container
(/root/reference/examples/pytorch/codefuse/codefuse_example.py:182-292, a flat
list with a fixed index layout) and the device-side weight structs
(/root/reference/src/fastertransformer/models/gptneox/GptNeoXWeight.{h,cc}).

Instead of raw pointer lists we use a nested dict pytree of jax.Arrays with all
per-layer tensors stacked along a leading ``[layer_num, ...]`` axis so the
transformer stack can be driven by ``lax.scan`` (one compiled block body instead
of ``layer_num`` unrolled copies).

Weight layouts (x @ W convention, in-features first):
  qkv_w   [L, H, 3*nH*dh]     fused QKV, column order (head, qkv, dh) — column-
                              parallel under TP: heads are the MAJOR part of the
                              flat axis, so a plain last-axis split is a head
                              split. This is HF's native ordering (no reorder at
                              convert time) and keeps the kernel rank-2, which
                              XLA/Mosaic tile without relayout copies (rank-4
                              int8 operands forced a 2.9GB layout copy).
  qkv_b   [L, 3*nH*dh]        same column order
  proj_w  [L, nH*dh, H]       row-parallel under TP (shard axis 1 = heads)
  proj_b  [L, H]              absent when use_gptj_residual (folded into down_b)
  up_w    [L, H, I]           column-parallel (shard I)
  up_b    [L, I]
  down_w  [L, I, H]           row-parallel (shard I)
  down_b  [L, H]              = attn.dense.bias + mlp.down.bias when gptj residual
                                (reference converter pre-sums them:
                                 huggingface_convert.py:193-206)

The reference instead reorders QKV to ``[hidden, 3, heads, head_dim]``
(huggingface_convert.py:64-74) because its TP split is a flat chunk of the
last axis; with heads-major ordering the same flat chunking IS the head split.

INT8 weight-only quantization (int8_mode=1) swaps each big kernel for a
``QuantizedTensor`` (int8 payload + per-output-channel fp32 scales), the analog
of the reference's DenseWeight{int8_kernel, weight_only_quant_scale}
(/root/reference/src/fastertransformer/layers/DenseWeight.h).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from ..core.config import GptNeoXConfig
from ..core.dtypes import jnp_dtype


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QuantizedTensor:
    """Weight-only-quantized kernel: int8 payload + per-output-channel scales.

    ``q`` keeps the logical (unquantized) kernel shape with dtype int8. ``scale``
    has ``q``'s shape with the contraction (K) axis removed; dequantized value is
    ``q * expand_dims(scale, k_axis)``. Per-output-channel symmetric scales —
    the same math as the reference's
    ``symmetric_quantize_last_axis_of_batched_matrix``
    (/root/reference/src/fastertransformer/th_op/common/WeightOnlyQuantOps.cc:140-233)
    minus the CUTLASS layout interleaving, which the XLA GEMMs do not need.
    """

    q: jax.Array  # int8 container; for bits=4 the K axis is nibble-packed (K/2)
    scale: jax.Array  # f32; per-output-channel: logical shape minus the K axis.
    # group-wise (group_size set): K axis replaced by K/group_size groups.
    k_axis: int = -2  # contraction axis of q, end-relative (static / aux data)
    group_size: int = 0  # 0 = per-output-channel; G>0 = per-(K-group, channel)
    bits: int = 8  # 8 = one int8/elem; 4 = two int4 nibbles per int8 along K,
    # INTERLEAVED: logical row 2i sits in byte-row i's LOW nibble and row 2i+1
    # in its HIGH nibble; the unpack is two int8 shifts. The payload stays in
    # an int8 container. The reference's CUTLASS fpA-intB path has the same two
    # widths (WeightOnlyQuantOps.cc int4 pack/unpack helpers).

    def tree_flatten(self):
        return (self.q, self.scale), (self.k_axis, self.bits, self.group_size)

    @classmethod
    def tree_unflatten(cls, aux, children):
        q, scale = children
        k_axis, bits, group_size = aux
        return cls(q=q, scale=scale, k_axis=k_axis, bits=bits, group_size=group_size)

    @property
    def shape(self):
        """Logical (unquantized) kernel shape."""
        if self.bits == 4:
            shape = list(self.q.shape)
            shape[self.k_axis % len(shape)] *= 2
            return tuple(shape)
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    def unpack(self) -> jax.Array:
        """int8 values in the logical shape (sign-extended nibbles for bits=4)."""
        if self.bits == 8:
            return self.q
        k_ax = self.k_axis % self.q.ndim
        lo = jnp.right_shift(jnp.left_shift(self.q, 4), 4)  # arithmetic: sign-extend
        hi = jnp.right_shift(self.q, 4)
        inter = jnp.stack([lo, hi], axis=k_ax + 1)  # [..., Kh, 2, ...]
        shape = list(self.q.shape)
        shape[k_ax] *= 2
        return inter.reshape(shape)

    def dequantize(self, dtype=jnp.float32):
        k_axis = self.k_axis % self.q.ndim
        if self.group_size:
            scale = jnp.repeat(
                self.scale.astype(jnp.float32), self.group_size, axis=k_axis
            )
        else:
            scale = jnp.expand_dims(self.scale, k_axis).astype(jnp.float32)
        return (self.unpack().astype(jnp.float32) * scale).astype(dtype)

    def __getitem__(self, idx):
        """Index the leading (layer) axis, keeping payload+scale consistent.

        ``k_axis`` is stored end-relative (negative) so it stays valid when the
        leading layer axis is peeled off (here and by lax.scan slicing).
        """
        assert self.k_axis < 0, "k_axis must be end-relative (negative)"
        return QuantizedTensor(
            q=self.q[idx], scale=self.scale[idx], k_axis=self.k_axis,
            bits=self.bits, group_size=self.group_size,
        )


Params = Dict[str, Any]


def init_params(
    config: GptNeoXConfig,
    rng: Optional[jax.Array] = None,
    dtype: Any = jnp.float32,
    std: float = 0.02,
    int8_mode: int = 0,
    weight_bits: int = 8,
    group_size: int = 0,
    quantize_embeddings: Optional[bool] = None,
) -> Params:
    """Random-init a full parameter pytree (tests / benchmarks).

    With int8_mode=1 the four big per-layer kernels are created directly as
    QuantizedTensors (random int8 + small scales), mirroring the reference's
    pre-quantized checkpoint path (enable_int8_weights,
    codefuse_example.py:407-418).

    ``quantize_embeddings`` additionally quantizes the embedding table and LM
    head (per-row int8 scales; transposed packed int4 head when
    weight_bits=4) — an engine extension the reference does not have (it keeps
    these fp16, codefuse_example.py:273-285). ``int8_mode=2`` is accepted as a
    back-compat alias for this flag; note the REFERENCE reserves int8_mode=2
    for SmoothQuant full-int8 (unsupported on its gptneox path), so the alias
    is deprecated in favor of the explicit flag.
    """
    if quantize_embeddings is None:
        quantize_embeddings = int8_mode >= 2
    dtype = jnp_dtype(dtype)
    L = config.layer_num
    H = config.hidden_size
    nH = config.head_num
    dh = config.size_per_head
    I = config.inter_size
    V = config.vocab_size

    if rng is None:
        rng = jax.random.PRNGKey(0)
    # the whole pytree is built inside ONE jit so generation transients
    # (uint32 PRNG bits, fp32 pre-cast normals) are fused/planned by XLA
    # instead of each living as a standalone device buffer — for 13B the
    # eager path's transients alone exceed a 16GB chip
    return jax.jit(
        lambda key: _init_params_inner(
            config, key, dtype, std, int8_mode, weight_bits, group_size,
            quantize_embeddings,
        )
    )(rng)


def _init_params_inner(
    config, rng, dtype, std, int8_mode, weight_bits=8, group_size=0,
    quantize_embeddings=False,
):
    L = config.layer_num
    H = config.hidden_size
    nH = config.head_num
    dh = config.size_per_head
    I = config.inter_size
    V = config.vocab_size
    keys = iter(jax.random.split(rng, 16))

    def dense(key, shape):
        return (jax.random.normal(key, shape, jnp.float32) * std).astype(dtype)

    def rand_i8(key, shape):
        # random.bits(uint8) keeps the transient footprint at 1 byte/elem;
        # random.randint would materialize an int32 intermediate (4x)
        return jax.lax.bitcast_convert_type(
            jax.random.bits(key, shape, jnp.uint8), jnp.int8
        )

    def maybe_quant(key, shape, k_axis):
        if int8_mode >= 1:
            qkey, skey = jax.random.split(key)
            qshape = list(shape)
            if weight_bits == 4:
                qshape[k_axis % len(shape)] //= 2  # nibble-packed container
            q = rand_i8(qkey, tuple(qshape))
            k_ax = k_axis % len(shape)
            if group_size:
                scale_shape = list(shape)
                scale_shape[k_ax] //= group_size
                scale_shape = tuple(scale_shape)
            else:
                scale_shape = tuple(s for i, s in enumerate(shape) if i != k_ax)
            qmax = 127.0 if weight_bits == 8 else 7.0
            scale = (
                jax.random.uniform(skey, scale_shape, jnp.float32, 0.5, 1.5) * std / qmax
            )
            if group_size:
                from ..ckpt.quantize import group_scale_dtype

                scale = scale.astype(group_scale_dtype(weight_bits, group_size))
            return QuantizedTensor(
                q=q, scale=scale, k_axis=k_axis, bits=weight_bits, group_size=group_size
            )
        return dense(key, shape)

    layers = {
        "ln1_w": jnp.ones((L, H), dtype),
        "qkv_w": maybe_quant(next(keys), (L, H, config.qkv_cols), k_axis=-2),
        "proj_w": maybe_quant(next(keys), (L, nH * dh, H), k_axis=-2),
        "ln2_w": jnp.ones((L, H), dtype),
    }
    if config.moe_experts:
        # MoE (Mixtral family): router + expert-stacked FFN weights, fp —
        # the E axis shards under expert parallelism (parallel/sharding.py)
        E = config.moe_experts
        layers["router_w"] = dense(next(keys), (L, H, E))
        layers["eup_w"] = dense(next(keys), (L, E, H, I))
        layers["edown_w"] = dense(next(keys), (L, E, I, H))
        if config.gated_ffn:
            layers["egate_w"] = dense(next(keys), (L, E, H, I))
    else:
        layers["up_w"] = maybe_quant(next(keys), (L, H, I), k_axis=-2)
        layers["down_w"] = maybe_quant(next(keys), (L, I, H), k_axis=-2)
        if config.gated_ffn:
            layers["gate_w"] = maybe_quant(next(keys), (L, H, I), k_axis=-2)
    if config.norm != "rmsnorm":
        layers["ln1_b"] = jnp.zeros((L, H), dtype)
        layers["ln2_b"] = jnp.zeros((L, H), dtype)
    if config.use_bias or config.qkv_bias:
        layers["qkv_b"] = jnp.zeros((L, config.qkv_cols), dtype)
    if config.use_bias:
        if not config.moe_experts:  # expert FFNs are bias-free (Mixtral)
            layers["up_b"] = jnp.zeros((L, I), dtype)
            layers["down_b"] = jnp.zeros((L, H), dtype)
        if not config.use_gptj_residual:
            layers["proj_b"] = jnp.zeros((L, H), dtype)

    def maybe_quant_rowwise(key, shape):
        # quantize_embeddings: embeddings/lm-head int8 too (per-row scales) —
        # the single-16GB-chip configuration for 13B (engine extension; the
        # reference always keeps these fp16)
        if quantize_embeddings:
            qkey, skey = jax.random.split(key)
            q = rand_i8(qkey, shape)
            scale = jax.random.uniform(skey, shape[:-1], jnp.float32, 0.5, 1.5) * std / 127.0
            return QuantizedTensor(q=q, scale=scale, k_axis=-1)
        return dense(key, shape)

    def lm_head_weight(key):
        if quantize_embeddings and weight_bits == 4:
            # int4 head: transposed [H, V_pad] packed layout feeding the W4
            # kernel; V pads to a 2560 multiple for wide divisor tiles
            # (ckpt.quantize.quantize_lm_head_int4)
            Vp = -(-V // 2560) * 2560
            qkey, skey = jax.random.split(key)
            q = rand_i8(qkey, (H // 2, Vp))
            scale = jax.random.uniform(skey, (Vp,), jnp.float32, 0.5, 1.5) * std / 7.0
            return QuantizedTensor(q=q, scale=scale, k_axis=-2, bits=4)
        return maybe_quant_rowwise(key, (V, H))

    out = {
        "embed": maybe_quant_rowwise(next(keys), (V, H)),
        "layers": layers,
        "final_ln_w": jnp.ones((H,), dtype),
        # [V, H]: H-minor feeds the logits GEMM without a transpose copy
        # (int4: transposed packed layout, see lm_head_weight)
        "lm_head": lm_head_weight(next(keys)),
    }
    if config.norm != "rmsnorm":
        out["final_ln_b"] = jnp.zeros((H,), dtype)
    if config.position_embedding == "learned":
        # additive absolute position table (GPT-2/OPT lineage); 2048 rows
        # bounds synthetic-model context — converters install the real wpe
        out["pos_embed"] = (
            jax.random.normal(next(keys), (2048, H), jnp.float32) * 0.01
        ).astype(dtype)
    return out


def cast_params(params: Params, dtype) -> Params:
    """Cast all float parameters to ``dtype`` (QuantizedTensor payloads stay int8)."""
    dtype = jnp_dtype(dtype)

    def cast(x):
        if isinstance(x, QuantizedTensor):
            return x
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree_util.tree_map(cast, params, is_leaf=lambda x: isinstance(x, QuantizedTensor))


def param_bytes(params: Params) -> int:
    leaves = jax.tree_util.tree_leaves(params)
    return sum(x.size * x.dtype.itemsize for x in leaves)


def layer_slice(stacked: dict, l) -> dict:
    """Per-layer view of a stacked-params dict, QuantizedTensor-aware
    (slices q and scale together; shared by the encoder families and T5)."""

    def sl(v):
        if isinstance(v, QuantizedTensor):
            return QuantizedTensor(
                q=v.q[l], scale=v.scale[l], k_axis=v.k_axis, bits=v.bits,
                group_size=v.group_size,
            )
        return v[l]

    return {k: sl(v) for k, v in stacked.items()}
