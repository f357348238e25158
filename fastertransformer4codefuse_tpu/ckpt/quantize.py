"""Offline INT8 weight-only quantization.

Rebuilds the reference's quantizer stack:
  - math: per-output-channel symmetric scales over the last axis, identical to
    ``symmetric_quantize_last_axis_of_batched_matrix``
    (/root/reference/src/fastertransformer/th_op/common/WeightOnlyQuantOps.cc:140-233)
  - offline tool: quantize the 4 GEMM kernels per layer and write ``.q.bin`` +
    ``.s.bin`` next to the fp checkpoint, like
    /root/reference/examples/pytorch/codefuse/quant_and_save.py:12-99.

Layout difference (deliberate): the reference preprocesses the int8 payload
into a CUTLASS tensor-core interleaved layout (permute rows for LDSM, subbyte
transpose, add_bias_and_interleave — cutlass_preprocessors.cc). The XLA GEMMs
here read plain row-major [K, N], so ``.q.bin`` files are plain row-major and
NOT interchangeable with the reference's.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import GptNeoXConfig
from ..models.params import Params, QuantizedTensor


def group_scale_dtype(bits: int, group_size: int):
    """Runtime dtype for group-wise scales.

    Group scales are [K/G, N] — 1/(G/4) of the weight-payload bytes when
    stored f32 (6.25% at G=128 int4), streamed by the kernel every decode
    step. bf16 halves that HBM traffic; the scale's ~0.4% rounding is noise
    under the 4-bit weight grid (measured in QUALITY.md). Per-channel scales
    are [N] — negligible — and stay f32. FTCF_GSCALE_BF16=0 restores f32."""
    if (
        bits == 4
        and group_size
        and os.environ.get("FTCF_GSCALE_BF16", "1") != "0"
    ):
        return jnp.bfloat16
    return jnp.float32


def quantize_array(
    w: jax.Array, k_axis: int = -2, bits: int = 8, group_size: int = 0
) -> QuantizedTensor:
    """Symmetric per-output-channel int8/int4 quantization.

    bits=8: ``scale[n] = max_k |w[k, n]| / 127``; ``q = round(w / scale)``.
    bits=4: scale uses /7, values clip to [-8, 7] and adjacent K-row pairs pack
    per byte (row 2i in the low nibble, row 2i+1 in the high, see
    QuantizedTensor.bits). Zero columns get scale 1 to avoid
    division by zero (the reference clamps the same way).

    Group-wise int4 scales are rounded to ``group_scale_dtype`` FIRST and the
    payload quantized against the rounded value, so the stored (scale, q) pair
    is self-consistent and the error bound |deq - w| <= scale/2 still holds.
    """
    assert bits in (8, 4)
    w32 = jnp.asarray(w, jnp.float32)
    k_ax = k_axis % w32.ndim
    qmax = 127.0 if bits == 8 else 7.0
    if group_size:
        # group-wise: scale per (K-group, out-channel) — the GPTQ/AWQ-style
        # granularity that keeps int4 usable in production
        K = w32.shape[k_ax]
        assert K % group_size == 0
        gshape = (
            w32.shape[:k_ax] + (K // group_size, group_size) + w32.shape[k_ax + 1:]
        )
        wg = w32.reshape(gshape)
        amax = jnp.max(jnp.abs(wg), axis=k_ax + 1)  # [..., K/G, ...]
        scale = jnp.where(amax > 0, amax / qmax, 1.0)
        sdt = group_scale_dtype(bits, group_size)
        scale = scale.astype(sdt)
        q = jnp.round(
            wg / jnp.expand_dims(scale.astype(jnp.float32), k_ax + 1)
        ).reshape(w32.shape)
    else:
        amax = jnp.max(jnp.abs(w32), axis=k_ax)
        scale = jnp.where(amax > 0, amax / qmax, 1.0)
        q = jnp.round(w32 / jnp.expand_dims(scale, k_ax))
    k_axis_rel = k_ax - w32.ndim
    if bits == 8:
        q = jnp.clip(q, -127, 127).astype(jnp.int8)
    else:
        q = jnp.clip(q, -8, 7).astype(jnp.int8)
        K = q.shape[k_ax]
        if group_size:
            assert group_size % 2 == 0
        assert K % 2 == 0, "int4 packing needs an even contraction dim"
        lo = jax.lax.slice_in_dim(q, 0, K, stride=2, axis=k_ax)
        hi = jax.lax.slice_in_dim(q, 1, K, stride=2, axis=k_ax)
        q = jnp.left_shift(hi, 4) | (lo & 0xF)
    return QuantizedTensor(
        q=q, scale=scale, k_axis=k_axis_rel, bits=bits, group_size=group_size
    )


_QUANT_KEYS = ("qkv_w", "proj_w", "up_w", "down_w", "gate_w")


def quantize_params(
    params: Params,
    include_embeddings: bool = False,
    weight_bits: int = 8,
    group_size: int = 0,
) -> Params:
    """Quantize the four big per-layer kernels (embeddings and lm head stay in
    the float dtype by default, exactly the reference's coverage —
    codefuse_example.py:273-285).

    ``include_embeddings=True`` additionally quantizes the token embedding
    (per-feature scales, dequantized after the gather) and the LM head
    (per-vocab-row scales applied on the fp32 logits) — needed to fit
    CodeFuse-13B on a single 16GB chip; the reference never faces this because
    A100s have 80GB.
    """
    layers = dict(params["layers"])
    for k in _QUANT_KEYS:
        w = layers.get(k)
        if w is None or isinstance(w, QuantizedTensor):
            continue
        layers[k] = quantize_array(
            w, k_axis=-2, bits=weight_bits, group_size=group_size
        )
    out = dict(params)
    out["layers"] = layers
    if include_embeddings:
        # per-vocab-row scales: token vector norms vary far more than feature
        # norms, and the row scale follows the gather / applies to the logit
        if not isinstance(out["embed"], QuantizedTensor):
            out["embed"] = quantize_array(out["embed"], k_axis=-1)  # scale [V]
        if not isinstance(out["lm_head"], QuantizedTensor):
            if weight_bits == 4:
                out["lm_head"] = quantize_lm_head_int4(out["lm_head"])
            else:
                out["lm_head"] = quantize_array(out["lm_head"], k_axis=-1)  # scale [V]
    return out


def quantize_lm_head_int4(w: jax.Array, tile: int = 2560) -> QuantizedTensor:
    """Int4 LM head in the kernel-feeding layout.

    The int8 LM head keeps HF's ``[V, H]`` with per-row scales, but int4
    nibble-packing must run along the CONTRACTION axis (H) — so the int4 head is stored
    TRANSPOSED ``[H, V_pad]`` (packed ``[H/2, V_pad]``, k_axis=-2, per-column
    scales = per-vocab-row), with V padded up to a multiple of ``tile`` (a
    2560 multiple divides evenly under every supported tensor-parallel
    degree). ``lm_logits`` slices the pad
    columns back off. Same scale math as the reference quantizer
    (WeightOnlyQuantOps.cc:140-233) at int4 width; layout is kernel-defined as
    on the CUTLASS side (cutlass_preprocessors.cc)."""
    V, H = w.shape
    Vp = -(-V // tile) * tile
    wt = jnp.asarray(w, jnp.float32).T  # [H, V]
    if Vp != V:
        wt = jnp.pad(wt, ((0, 0), (0, Vp - V)))
    return quantize_array(wt, k_axis=-2, bits=4)


def quantization_error(w: jax.Array, k_axis: int = -2) -> float:
    """Max abs reconstruction error (diagnostics / tests)."""
    qt = quantize_array(w, k_axis)
    return float(jnp.max(jnp.abs(qt.dequantize(jnp.float32) - jnp.asarray(w, jnp.float32))))


# --------------------------------------------------------------------------- #
# Offline tool: fp .bin dir -> .q.bin/.s.bin (quant_and_save.py analog)
# --------------------------------------------------------------------------- #

def quant_and_save(
    ckpt_path: str,
    config: Optional[GptNeoXConfig] = None,
    weight_names: Iterable[str] = (
        "attention.query_key_value.weight",
        "attention.dense.weight",
        "mlp.dense_h_to_4h.weight",
        "mlp.dense_4h_to_h.weight",
    ),
    weight_bits: int = 8,
    group_size: int = 0,
) -> None:
    """For every per-layer / per-rank fp kernel file write quantized payload +
    scale files next to it: ``.q.bin``/``.s.bin`` for int8 (plain row-major),
    ``.q4.bin``/``.s4.bin`` for nibble-packed int4 (optionally group-wise —
    group_size recorded in the filename as ``.s4gN.bin``)."""
    if config is None:
        config = GptNeoXConfig.from_ini(ckpt_path)
    wdt = np.float16 if config.weight_data_type == "fp16" else np.float32
    H = config.hidden_size

    import glob as _glob

    for i in range(config.layer_num):
        for name in weight_names:
            for path in sorted(
                _glob.glob(os.path.join(ckpt_path, f"model.layers.{i}.{name}.*.bin"))
            ):
                if path.endswith(".q.bin") or path.endswith(".s.bin"):
                    continue
                flat = np.fromfile(path, dtype=wdt)
                # every kernel layout here is [K, rest...]; per-output-channel
                # scale = over all-but-K, so reshape to [K, -1]
                k_dim = {
                    "attention.query_key_value.weight": H,
                    "attention.dense.weight": flat.size // H,
                    "mlp.dense_h_to_4h.weight": H,
                    "mlp.dense_4h_to_h.weight": flat.size // H,
                }[name]
                w = flat.reshape(k_dim, -1)
                qt = quantize_array(
                    jnp.asarray(w), k_axis=-2, bits=weight_bits, group_size=group_size
                )
                if weight_bits == 8:
                    np.asarray(qt.q).tofile(path[:-4] + ".q.bin")
                    np.asarray(qt.scale).astype(wdt).tofile(path[:-4] + ".s.bin")
                else:
                    suffix = f"g{group_size}" if group_size else ""
                    np.asarray(qt.q).tofile(path[:-4] + ".q4.bin")
                    np.asarray(qt.scale).astype(wdt).tofile(
                        path[:-4] + f".s4{suffix}.bin"
                    )
