"""Swin encoder family — shifted-window 2D attention.

The reference ships Swin as its own C++ engine with an int8 variant and a
TensorRT plugin (/root/reference/src/fastertransformer/models/swin/
SwinTransformer.cc, models/swin_int8/, tensorrt_plugin/swin/); third new
attention pattern through the kernel seam: attention runs INSIDE M×M pixel
windows (a [nW·B, M², dh] batched attention — MXU-friendly small GEMMs),
with learned relative-position biases per window and alternating SHIFTED
windows (cyclic roll by M/2 + a region mask so wrapped pixels don't attend
across the wrap seam). Patch merging halves the resolution and doubles the
width between stages, so the stage loop unrolls in Python (per-stage dims
differ — no lax.scan over stages).

Parity notes vs HF SwinModel (modeling_swin.py):
  - relative_position_index loads straight from the checkpoint buffer;
  - the shifted-window mask uses HF's -100.0 fill (not -inf);
  - patch merging gathers the 2×2 neighbors in (even-even, odd-even,
    even-odd, odd-odd) order, norms the 4C concat, then reduces bias-free;
  - pooled output = mean over the final sequence (AdaptiveAvgPool1d).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.layernorm import layernorm
from ..ops.linear import linear


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int
    patch_size: int
    embed_dim: int
    depths: Tuple[int, ...]
    num_heads: Tuple[int, ...]
    window_size: int
    num_channels: int = 3
    mlp_ratio: float = 4.0
    layernorm_eps: float = 1e-5
    activation: str = "gelu"
    model_name: str = "swin"


def config_from_hf_swin(hf_config, model_name="swin") -> SwinConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)
    return SwinConfig(
        image_size=g("image_size"),
        patch_size=g("patch_size"),
        embed_dim=g("embed_dim"),
        depths=tuple(g("depths")),
        num_heads=tuple(g("num_heads")),
        window_size=g("window_size"),
        num_channels=g("num_channels", 3),
        mlp_ratio=float(g("mlp_ratio", 4.0)),
        layernorm_eps=float(g("layer_norm_eps", 1e-5)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh"}.get(
            g("hidden_act", "gelu"), "gelu"
        ),
        model_name=model_name,
    )


def params_from_hf_swin_state_dict(
    config: SwinConfig, state_dict: Mapping[str, Any], dtype=jnp.float32
) -> Dict[str, Any]:
    from ..ckpt.convert import _np

    sd = dict(state_dict)
    pre = "swin." if "swin.embeddings.patch_embeddings.projection.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    conv_w = get("embeddings.patch_embeddings.projection.weight")
    E = conv_w.shape[0]
    stages: List[Dict[str, Any]] = []
    for si, depth in enumerate(config.depths):
        blocks = []
        for bi in range(depth):
            p = f"encoder.layers.{si}.blocks.{bi}."
            a = p + "attention."
            blocks.append({
                "ln1_w": jnp.asarray(get(p + "layernorm_before.weight"), dtype),
                "ln1_b": jnp.asarray(get(p + "layernorm_before.bias"), dtype),
                "bias_table": jnp.asarray(
                    get(a + "self.relative_position_bias_table"), dtype
                ),
                "bias_index": jnp.asarray(
                    get(a + "self.relative_position_index"), jnp.int32
                ),
                "q_w": jnp.asarray(get(a + "self.query.weight").T, dtype),
                "q_b": jnp.asarray(get(a + "self.query.bias"), dtype),
                "k_w": jnp.asarray(get(a + "self.key.weight").T, dtype),
                "k_b": jnp.asarray(get(a + "self.key.bias"), dtype),
                "v_w": jnp.asarray(get(a + "self.value.weight").T, dtype),
                "v_b": jnp.asarray(get(a + "self.value.bias"), dtype),
                "proj_w": jnp.asarray(get(a + "output.dense.weight").T, dtype),
                "proj_b": jnp.asarray(get(a + "output.dense.bias"), dtype),
                "ln2_w": jnp.asarray(get(p + "layernorm_after.weight"), dtype),
                "ln2_b": jnp.asarray(get(p + "layernorm_after.bias"), dtype),
                "up_w": jnp.asarray(get(p + "intermediate.dense.weight").T, dtype),
                "up_b": jnp.asarray(get(p + "intermediate.dense.bias"), dtype),
                "down_w": jnp.asarray(get(p + "output.dense.weight").T, dtype),
                "down_b": jnp.asarray(get(p + "output.dense.bias"), dtype),
            })
        stage = {"blocks": blocks}
        dkey = f"encoder.layers.{si}.downsample.reduction.weight"
        if pre + dkey in sd:
            stage["down_reduction"] = jnp.asarray(get(dkey).T, dtype)  # [4C, 2C]
            stage["down_ln_w"] = jnp.asarray(
                get(f"encoder.layers.{si}.downsample.norm.weight"), dtype)
            stage["down_ln_b"] = jnp.asarray(
                get(f"encoder.layers.{si}.downsample.norm.bias"), dtype)
        stages.append(stage)
    return {
        "patch_w": jnp.asarray(conv_w.reshape(E, -1).T, dtype),
        "patch_b": jnp.asarray(get("embeddings.patch_embeddings.projection.bias"), dtype),
        "embed_ln_w": jnp.asarray(get("embeddings.norm.weight"), dtype),
        "embed_ln_b": jnp.asarray(get("embeddings.norm.bias"), dtype),
        "stages": stages,
        "final_ln_w": jnp.asarray(get("layernorm.weight"), dtype),
        "final_ln_b": jnp.asarray(get("layernorm.bias"), dtype),
    }


def _window_partition(x, M):
    """[B, H, W, C] -> [B*nW, M*M, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // M, M, W // M, M, C)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, M * M, C)


def _window_merge(w, M, H, W):
    B = w.shape[0] // ((H // M) * (W // M))
    x = w.reshape(B, H // M, W // M, M, M, -1)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _shift_mask(H, W, M, shift):
    """HF's img_mask regions -> [nW, M*M, M*M] additive mask (-100 across
    region boundaries of the cyclic wrap)."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -M), slice(-M, -shift), slice(-shift, None)):
        for w in (slice(0, -M), slice(-M, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    mw = np.asarray(_window_partition(jnp.asarray(img), M))[:, :, 0]  # [nW, M*M]
    diff = mw[:, None, :] - mw[:, :, None]
    return jnp.asarray(np.where(diff != 0, -100.0, 0.0), jnp.float32)


def _block(cfg: SwinConfig, bp, x, H, W, nH, shift):
    """One Swin block on [B, H*W, C]; pre-LN, windowed (+shifted) attention."""
    B, L, C = x.shape
    M = min(cfg.window_size, H, W)
    if min(H, W) <= cfg.window_size:
        shift = 0
    dh = C // nH
    shortcut = x
    h = layernorm(x, bp["ln1_w"], bp["ln1_b"], cfg.layernorm_eps)
    h = h.reshape(B, H, W, C)
    # pad to window multiples (right/bottom), shift, partition
    Hp, Wp = -(-H // M) * M, -(-W // M) * M
    h = jnp.pad(h, ((0, 0), (0, Hp - H), (0, Wp - W), (0, 0)))
    if shift:
        h = jnp.roll(h, (-shift, -shift), axis=(1, 2))
    wins = _window_partition(h, M)  # [B*nW, M*M, C]
    q = linear(wins, bp["q_w"], bp["q_b"]).reshape(-1, M * M, nH, dh)
    k = linear(wins, bp["k_w"], bp["k_b"]).reshape(-1, M * M, nH, dh)
    v = linear(wins, bp["v_w"], bp["v_b"]).reshape(-1, M * M, nH, dh)
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32) / (dh ** 0.5)
    rel = bp["bias_table"][bp["bias_index"].reshape(-1)].reshape(
        M * M, M * M, nH
    ).transpose(2, 0, 1)  # [nH, M*M, M*M]
    scores = scores + rel[None].astype(jnp.float32)
    if shift:
        nW = (Hp // M) * (Wp // M)
        mask = _shift_mask(Hp, Wp, M, shift)  # [nW, M*M, M*M]
        scores = scores.reshape(B, nW, nH, M * M, M * M)
        scores = scores + mask[None, :, None]
        scores = scores.reshape(-1, nH, M * M, M * M)
    probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    ctx = jnp.einsum("bhqk,bkhd->bqhd", probs, v,
                     preferred_element_type=jnp.float32).astype(x.dtype)
    ctx = linear(ctx.reshape(-1, M * M, C), bp["proj_w"], bp["proj_b"])
    h = _window_merge(ctx, M, Hp, Wp)
    if shift:
        h = jnp.roll(h, (shift, shift), axis=(1, 2))
    h = h[:, :H, :W].reshape(B, L, C)
    x = shortcut + h
    h2 = layernorm(x, bp["ln2_w"], bp["ln2_b"], cfg.layernorm_eps)
    f = linear(h2, bp["up_w"], bp["up_b"], act=cfg.activation)
    f = linear(f, bp["down_w"], bp["down_b"])
    return x + f


def encode(config: SwinConfig, params: Dict[str, Any], pixels: jax.Array):
    """Full Swin pass. pixels [B, C, H, W] -> (hidden [B, L_last, C_last],
    pooled [B, C_last])."""
    from .vit import patchify

    B = pixels.shape[0]
    P = config.patch_size
    H = pixels.shape[2] // P
    W = pixels.shape[3] // P
    # reuse ViT's patchify: stride-P conv == reshape + GEMM
    vcfg = type("_", (), {"patch_size": P})()
    x = linear(patchify(vcfg, pixels), params["patch_w"], params["patch_b"])
    x = layernorm(x, params["embed_ln_w"], params["embed_ln_b"],
                  config.layernorm_eps)

    for si, stage in enumerate(params["stages"]):
        nH = config.num_heads[si]
        for bi, bp in enumerate(stage["blocks"]):
            shift = 0 if bi % 2 == 0 else config.window_size // 2
            x = _block(config, bp, x, H, W, nH, shift)
        if "down_reduction" in stage:
            # patch merging: 2x2 neighbors (ee, oe, eo, oo) -> norm -> reduce
            C = x.shape[-1]
            g = x.reshape(B, H, W, C)
            m = jnp.concatenate(
                [g[:, 0::2, 0::2], g[:, 1::2, 0::2],
                 g[:, 0::2, 1::2], g[:, 1::2, 1::2]], axis=-1
            ).reshape(B, (H // 2) * (W // 2), 4 * C)
            m = layernorm(m, stage["down_ln_w"], stage["down_ln_b"],
                          config.layernorm_eps)
            x = linear(m, stage["down_reduction"])  # bias-free
            H, W = H // 2, W // 2

    x = layernorm(x, params["final_ln_w"], params["final_ln_b"],
                  config.layernorm_eps)
    return x, jnp.mean(x, axis=1)
