"""Int8 weight-only GEMV over a stacked weight, as a Pallas kernel for the GPU
(Triton).

At decode widths (M <= 16 rows) a layer's GEMM is bound by its weight bytes.
Inside the layer scan, XLA slices the stacked ``[L, K, N]`` int8 weight by the
traced layer index into a fresh buffer before its GEMM reads it
(``loop_dynamic_slice_fusion`` in the trace), so every step reads each weight
twice and writes it once. This kernel takes the stacked weight and the layer
index as operands and reads the layer's bytes once, in place: int8 loads,
conversion in registers, bf16 tensor-core products with float32 sums; the
per-channel scale is applied after the split-K partial sums are added.

The analog of the reference's CUTLASS fpA-intB GEMM at decode widths
(kernels/cutlass_kernels/fpA_intB_gemm/). ``quantized_matmul_xla`` in
ops/linear.py is the plain version it is tested against.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .flash_decode import _TARGET_PROGRAMS, _words

MAX_M = 16  # rows per call: decode widths; wider calls stay on XLA's GEMM


def supported(M: int, K: int, N: int, bk: int = 128) -> bool:
    return M <= MAX_M and K % bk == 0 and N % 128 == 0


def _kernel(layer_ref, x_ref, q_ref, o_ref, *, bk, bn, chunks_per_split,
            n_chunks, dot_dtype):
    j = pl.program_id(0)
    sp = pl.program_id(1)
    layer = layer_ref[0]
    w = bn // 2  # int16 words per output block: two output columns each
    cols = pl.ds(j * w, w)

    def body(c, acc):
        acc_lo, acc_hi = acc
        xk = x_ref[:, pl.ds(c * bk, bk)].astype(dot_dtype)  # [Mp, bk]
        words = q_ref[layer, pl.ds(c * bk, bk), cols].astype(jnp.int32)
        lo = ((words << 24) >> 24).astype(dot_dtype)  # column 2i
        hi = (words >> 8).astype(dot_dtype)  # column 2i + 1
        acc_lo = acc_lo + pl.dot(xk, lo)
        acc_hi = acc_hi + pl.dot(xk, hi)
        return acc_lo, acc_hi

    Mp = x_ref.shape[0]
    zeros = jnp.zeros((Mp, w), jnp.float32)
    lo = sp * chunks_per_split
    hi = jnp.minimum(lo + chunks_per_split, n_chunks)
    acc_lo, acc_hi = lax.fori_loop(lo, hi, body, (zeros, zeros))
    o_ref[:, pl.ds(0, w, 2)] = acc_lo
    o_ref[:, pl.ds(1, w, 2)] = acc_hi


@functools.partial(
    jax.jit, static_argnames=("bk", "bn", "interpret", "num_warps", "num_stages")
)
def int8_gemv_stacked(
    x: jax.Array,  # [M, K] activations, M <= MAX_M
    q: jax.Array,  # [L, K, N] int8 stacked weight
    scale: jax.Array,  # [L, N] per-output-channel scales
    layer: jax.Array,  # scalar
    bk: int = 128,
    bn: int = 256,  # output columns per program (128 when N is not a multiple)
    interpret: bool = False,
    num_warps: int = 4,
    num_stages: int = 3,
) -> jax.Array:
    """``(x @ q[layer]) * scale[layer]`` in float32, shape [M, N]."""
    M, K = x.shape
    L, K2, N = q.shape
    assert K == K2 and supported(M, K, N, bk), (M, K, N)
    if N % bn:
        bn = 128
    Mp = MAX_M
    xp = jnp.zeros((Mp, K), x.dtype).at[:M].set(x)
    n_blocks = N // bn
    n_chunks = K // bk
    n_split = max(1, min(n_chunks, -(-_TARGET_PROGRAMS // n_blocks)))
    per_split = -(-n_chunks // n_split)
    n_split = -(-n_chunks // per_split)
    whole = pl.no_block_spec
    part = pl.pallas_call(
        functools.partial(
            _kernel, bk=bk, bn=bn, chunks_per_split=per_split, n_chunks=n_chunks,
            # the CPU interpreter has no bf16 dot
            dot_dtype=jnp.float32 if interpret else jnp.bfloat16,
        ),
        grid=(n_blocks, n_split),
        in_specs=[whole, whole, whole],
        out_specs=pl.BlockSpec((None, Mp, bn), lambda j, s: (s, 0, j)),
        out_shape=jax.ShapeDtypeStruct((n_split, Mp, N), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="ftcf_int8_gemv",
    )(jnp.asarray(layer, jnp.int32).reshape(1), xp, _words(q))
    s = jax.lax.dynamic_index_in_dim(scale, layer, 0, keepdims=False)
    return jnp.sum(part[:, :M], axis=0) * s[None, :].astype(jnp.float32)
