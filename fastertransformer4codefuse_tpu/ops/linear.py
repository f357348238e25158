"""Linear / matmul with optional weight-only int8/int4 dequantization.

The analog of the reference's GEMM dispatch: cuBLAS for dense
(/root/reference/src/fastertransformer/utils/cublasMMWrapper.cc) and the CUTLASS
fpA-intB mixed GEMM for int8 weight-only
(/root/reference/src/fastertransformer/kernels/cutlass_kernels/fpA_intB_gemm/).

Every path is plain XLA: the dense path is a ``jnp.dot`` (XLA picks cuBLAS or
its own GEMM and fuses the bias/activation epilogue); the int8 path multiplies
the int8 payload converted to the activation dtype and applies the
per-output-channel scale on the fp32 accumulator, which XLA can fuse into the
GEMM's prologue and epilogue.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from ..models.params import QuantizedTensor
from . import routes


def apply_act(y: jax.Array, act: str) -> jax.Array:
    """Activation by name; exact-erf gelu is the HF/CodeFuse checkpoint
    default, tanh-gelu the reference engine's own FFN formula."""
    if act == "gelu":
        return jax.nn.gelu(y, approximate=False)
    if act == "gelu-tanh":
        return jax.nn.gelu(y, approximate=True)
    if act == "relu":
        return jax.nn.relu(y)
    if act == "silu":
        return jax.nn.silu(y)
    raise ValueError(f"unknown activation {act!r}")


def _as_2d_weight(w: QuantizedTensor):
    """Collapse a structured kernel (e.g. qkv [H, 3, N]) to 2D [K, N_total]."""
    k_axis = w.k_axis % w.q.ndim
    assert k_axis == 0, f"expected per-layer kernel with k_axis=0, got {k_axis}"
    K = w.q.shape[0]
    q2d = w.q.reshape(K, -1)
    scale = w.scale.reshape(-1)
    return q2d, scale


def quantized_matmul_xla(x: jax.Array, w: QuantizedTensor) -> jax.Array:
    """int8/int4 weight-only matmul as an XLA composition.

    y = (x @ q.astype(x.dtype)) * scale  — the scale is per output channel so it
    commutes out of the contraction; the convert can fuse into the GEMM's
    operand load and the scale multiply into its epilogue.

    bits=4: the nibble unpack runs as plain int8 shifts, and the weight is
    dequantized before the dot.
    """
    if w.group_size or w.bits == 4:
        # dequantize the (per-layer) weight, plain dot
        out_shape = x.shape[:-1] + w.q.shape[w.q.ndim - 1:]
        x2d = x.reshape(-1, x.shape[-1])
        wd = w.dequantize(x.dtype).reshape(x.shape[-1], -1)
        acc = jnp.dot(x2d, wd, preferred_element_type=jnp.float32)
        return acc.astype(x.dtype).reshape(out_shape)
    q2d, scale = _as_2d_weight(w)
    out_shape = x.shape[:-1] + w.q.shape[1:]
    x2d = x.reshape(-1, x.shape[-1])
    acc = jnp.dot(x2d, q2d.astype(x.dtype), preferred_element_type=jnp.float32)
    y = acc * scale[None, :].astype(jnp.float32)
    return y.astype(x.dtype).reshape(out_shape)


# SmoothQuant-style activation-int8 GEMMs (the reference's int8_mode=2
# semantics — ckpt/smoothquant.py) when ``routes.current().act_int8``
# (RuntimeConfig.act_int8). Calls narrower than this stay on the weight-only
# path: decode-width GEMMs
# are weight-bytes-bound, so activation quantization saves nothing there and
# the per-token quant ops are pure overhead; an int8 tensor-core tile is 16
# rows high. Prefill/chunk calls (M = B*S) clear the bar and ride the int8 x
# int8 dot, which the tensor cores run at twice the bf16 rate.
_A8_MIN_M = 16


def w8a8_matmul(
    x2d: jax.Array,  # [M, K] float
    q: jax.Array,  # [K, N] int8 (per-output-channel scales)
    scale: jax.Array,  # [N]
    bias=None,
    act=None,
    out_dtype=None,
) -> jax.Array:
    """Per-token dynamic activation int8 + int8 x int8 dot + fp32 requant.

    y = (round(x / s_x) @ q) * s_x * scale — both scale factors commute out
    of the int32 accumulator. Accuracy rides the SmoothQuant fold (per-token
    s_x absorbs what the fold moved out of the activations)."""
    xf = x2d.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=1)
    s_x = jnp.where(amax > 0, amax / 127.0, 1.0)
    x8 = jnp.round(xf / s_x[:, None]).astype(jnp.int8)
    acc = jax.lax.dot_general(
        x8, q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    y = acc.astype(jnp.float32) * s_x[:, None] * scale[None, :].astype(jnp.float32)
    y = y.astype(out_dtype if out_dtype is not None else x2d.dtype)
    return _bias_act_xla(y, bias, act)


def _bias_act_xla(y: jax.Array, bias, act) -> jax.Array:
    """Bias + activation as XLA ops (they fuse into the GEMM's epilogue)."""
    if bias is not None:
        y = y + bias.astype(y.dtype)
    if act is not None:
        y = apply_act(y, act)
    return y


def quantized_matmul(
    x: jax.Array,
    w: QuantizedTensor,
    layer: Optional[jax.Array] = None,
    bias: Optional[jax.Array] = None,
    act: Optional[str] = None,
) -> jax.Array:
    """Dispatch; bias/activation are always applied. ``layer`` set + a
    stacked [L, K, N] weight selects that layer (a leading-axis dynamic
    slice that feeds the dot)."""
    stacked = layer is not None and w.q.ndim == 3
    route = routes.current()
    if (
        route.act_int8
        and w.bits == 8
        and not w.group_size
        and x.ndim >= 3
        and x.shape[-2] > 1  # sequence width: decode steps ([B, 1, H]) stay
        # weight-only even at wide pool batch — they are weight-bytes-bound,
        # so activation quantization is pure overhead there
        and math.prod(x.shape[:-1]) >= _A8_MIN_M
    ):
        # SmoothQuant W8A8 (batch-wide calls only — see _A8_MIN_M). bits == 8
        # ONLY: int4 nibbles would be unpacked into a full [K, N] int8 copy
        # per layer before the dot, and group-wise scales sit inside K, so
        # they cannot commute out of the int32 accumulator at all.
        if stacked:
            q = jax.lax.dynamic_index_in_dim(w.q, layer, 0, keepdims=False)
            scale = jax.lax.dynamic_index_in_dim(
                w.scale, layer, 0, keepdims=False
            )
        else:
            q, scale = _as_2d_weight(w)
        out_shape = x.shape[:-1] + w.q.shape[2 if stacked else 1:]
        y = w8a8_matmul(
            x.reshape(-1, x.shape[-1]), q, scale, bias=bias, act=act,
            out_dtype=x.dtype,
        )
        return y.reshape(out_shape)
    if stacked and route.int8_gemv and w.bits == 8 and not w.group_size:
        # the Triton GEMV (GPU engines) reads the layer's weight in place
        # instead of XLA's per-layer slice copy
        from . import int8_gemv

        M, K, N = math.prod(x.shape[:-1]), w.q.shape[1], w.q.shape[2]
        if int8_gemv.supported(M, K, N):
            y = int8_gemv.int8_gemv_stacked(
                x.reshape(M, K), w.q, w.scale.reshape(w.q.shape[0], N), layer,
                interpret=route.interpret,
            )
            y = y.astype(x.dtype).reshape(x.shape[:-1] + (N,))
            return _bias_act_xla(y, bias, act)
    if stacked:
        w = w[layer]
    return _bias_act_xla(quantized_matmul_xla(x, w), bias, act)


def quantized_matmul_transposed_head(x: jax.Array, w: QuantizedTensor) -> jax.Array:
    """fp32-out logits GEMM against the [K, V_pad] (k_axis=0) quantized LM head."""
    assert w.k_axis % w.q.ndim == 0
    wk = w.unpack()
    if w.group_size:
        # fold the [K/G, N] group scales into the weight before the dot (they
        # sit inside the contraction, so no epilogue form exists)
        K, N = wk.shape
        G = w.group_size
        wd = (
            wk.astype(jnp.float32).reshape(K // G, G, N)
            * w.scale[:, None, :].astype(jnp.float32)
        ).reshape(K, N).astype(x.dtype)
        return jnp.dot(x, wd, preferred_element_type=jnp.float32)
    acc = jnp.dot(x, wk.astype(x.dtype), preferred_element_type=jnp.float32)
    return acc * w.scale[None, :].astype(jnp.float32)


def linear(
    x: jax.Array,
    w,
    b: Optional[jax.Array] = None,
    out_dtype=None,
    layer: Optional[jax.Array] = None,
    act: Optional[str] = None,
) -> jax.Array:
    """``y = act(x @ w + b)`` with QuantizedTensor dispatch.

    ``w`` may be a plain array ``[K, ...out]``, a per-layer QuantizedTensor, or
    (with ``layer`` set) a stacked ``[L, K, N]`` QuantizedTensor; bias and
    activation ride XLA's epilogue fusion.
    """
    if isinstance(w, QuantizedTensor):
        y = quantized_matmul(x, w, layer=layer, bias=b, act=act)
    else:
        out_shape = x.shape[:-1] + w.shape[1:]
        x2d = x.reshape(-1, x.shape[-1])
        w2d = w.reshape(w.shape[0], -1)
        y = jnp.dot(x2d, w2d, preferred_element_type=jnp.float32)
        y = _bias_act_xla(y.astype(x.dtype).reshape(out_shape), b, act)
    if out_dtype is not None:
        y = y.astype(out_dtype)
    return y
