"""SmoothQuant: activation-int8 (W8A8) preparation — the reference's
``int8_mode=2`` semantics (SURVEY §2.2; src/fastertransformer/models/
multi_gpu_gpt int8_mode==2 runs SmoothQuant int8xint8 GEMMs — the gptneox
family never wired it, so this is parity-plus for the CodeFuse path).

Recipe (Xiao et al., "SmoothQuant", ICML'23): per-input-channel smoothing
factors s_k = amax_act_k^alpha / amax_w_k^(1-alpha) migrate quantization
difficulty from activations (outlier channels) into weights. The factors
fold EXACTLY into the preceding normalization's affine — the same fp-exact
rewrite as the AWQ fold (ckpt/calibrate.apply_awq_scaling) but with the
balance formula instead of a reconstruction-error grid search:

    qkv_w[l]  *= s      ln1_w[l] /= s   (ln1_b too, when present)
    up_w[l]   *= s'     ln2_w[l] /= s'  (gate_w shares s' under SwiGLU:
                                         both read the same ln2 output)

proj/down have no preceding affine (their inputs come from attention / the
nonlinearity); their activations are tame post-softmax / post-activation, so
they quantize per-token at runtime without smoothing — the same coverage the
SmoothQuant paper applies to GPT blocks.

Runtime: engine ``RuntimeConfig(act_int8=True)`` routes batch-wide GEMMs
(prefill, chunked prefill) through ops/linear.w8a8_matmul — per-token dynamic
activation int8 + int8 x int8 dot (twice the bf16 tensor-core rate) + fp32
requant epilogue. Decode-width calls keep the weight-only path (they are
weight-bytes-bound; activation quantization there saves nothing).

Flow:
    stats  = calibrate.collect_activation_stats(cfg, params, batches)
    params = apply_smoothquant_scaling(cfg, params, stats, alpha=0.5)
    qp     = quantize.quantize_params(params)   # int8 per-channel
    eng    = GptNeoXEngine(cfg, qp, RuntimeConfig(int8_mode=1, act_int8=True))
"""
from __future__ import annotations

from typing import Dict

import numpy as np

import jax.numpy as jnp

from ..core.config import GptNeoXConfig
from ..models.params import Params


def smoothquant_scales(
    amax_act: np.ndarray,  # [K] per-input-channel activation amax
    w: np.ndarray,  # [K, N] weight
    alpha: float = 0.5,
) -> np.ndarray:
    """s_k = amax_act_k^alpha / amax_w_k^(1-alpha), clamped away from 0."""
    a = np.maximum(np.asarray(amax_act, np.float32), 1e-5)
    wmax = np.maximum(np.abs(np.asarray(w, np.float32)).max(axis=1), 1e-5)
    s = a**alpha / wmax ** (1.0 - alpha)
    return np.maximum(s, 1e-5).astype(np.float32)


def apply_smoothquant_scaling(
    config: GptNeoXConfig,
    params: Params,
    stats: Dict[str, np.ndarray],  # from calibrate.collect_activation_stats
    alpha: float = 0.5,
) -> Params:
    """Fold SmoothQuant factors into the norm affines — fp-forward-EXACT
    (tested): quantize with ckpt.quantize.quantize_params afterwards."""
    assert not config.moe_experts, (
        "SmoothQuant folding targets dense FFN blocks; MoE expert weights "
        "(egate_w/eup_w) are not covered (and the positional calibration "
        "recorder does not see MoE's batched expert GEMMs)"
    )
    layers = dict(params["layers"])
    L = config.layer_num
    groups = [("ln1", ["qkv_w"], "qkv")]
    ffn_ws = ["gate_w", "up_w"] if config.gated_ffn else ["up_w"]
    groups.append(("ln2", [k for k in ffn_ws if k in layers], "up"))
    for ln_key, w_keys, st_key in groups:
        ws = {k: np.array(layers[k], np.float32) for k in w_keys}
        ln_w = np.array(layers[f"{ln_key}_w"], np.float32)
        has_b = f"{ln_key}_b" in layers
        ln_b = np.array(layers[f"{ln_key}_b"], np.float32) if has_b else None
        for l in range(L):
            # one s per ln output: the widest consumer's weight range governs
            w_cat = np.concatenate([ws[k][l] for k in w_keys], axis=1)
            s = smoothquant_scales(stats[st_key][l], w_cat, alpha)
            for k in w_keys:
                ws[k][l] *= s[:, None]
            ln_w[l] /= s
            if has_b:
                ln_b[l] /= s
        for k in w_keys:
            layers[k] = jnp.asarray(ws[k], params["layers"][k].dtype)
        layers[f"{ln_key}_w"] = jnp.asarray(
            ln_w, params["layers"][f"{ln_key}_w"].dtype
        )
        if has_b:
            layers[f"{ln_key}_b"] = jnp.asarray(
                ln_b, params["layers"][f"{ln_key}_b"].dtype
            )
    out = dict(params)
    out["layers"] = layers
    return out
