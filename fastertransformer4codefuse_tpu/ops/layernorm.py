"""LayerNorm in fp32 statistics.

Replaces the reference's invokeGeneralLayerNorm / fused residual variants
(/root/reference/src/fastertransformer/kernels/layernorm_kernels.cu). These
are plain element-wise ops and reductions that XLA fuses with their
neighbours, so no kernel is needed — only the fp32-statistics discipline
matters.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def layernorm(x: jax.Array, w: jax.Array, b, eps: float = 1e-5) -> jax.Array:
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    y = y * w.astype(jnp.float32)
    if b is not None:
        y = y + b.astype(jnp.float32)
    return y.astype(x.dtype)


def rmsnorm(x: jax.Array, w: jax.Array, eps: float = 1e-5) -> jax.Array:
    """RMSNorm (LLaMA-family): no mean subtraction, no bias; fp32 statistics
    like HF LlamaRMSNorm (the scale multiply happens after the cast back in
    HF — we match that order for parity)."""
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    y = (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype)
    return y * w.astype(x.dtype)
