"""GSPMD sharding rules: the replacement for the reference's NCCL
tensor parallelism (SURVEY §2.4).

The reference column-splits QKV/FFN-up and row-splits proj/FFN-down per rank
(huggingface_convert.py:44-74) and all-reduces once per layer under the
parallel residual (GptNeoXDecoder.cc:342-360). Here the same math is expressed
as PartitionSpecs over a ("dp", "tp") mesh; XLA's SPMD partitioner inserts the
single per-layer psum automatically because attn_out and ffn_out are both
partial sums over "tp".
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import GptNeoXConfig
from ..models.params import Params, QuantizedTensor


def build_mesh(tp: int = 1, dp: int = 1, pp: int = 1, devices=None) -> Mesh:
    """Device mesh with ("dp", "pp", "tp") axes over the first
    ``tp * dp * pp`` devices. The GPUs of one host reach each other all to
    all over NVLink at one rate, so the axis order follows the algorithm
    alone: TP innermost, PP between, DP outermost."""
    if devices is None:
        devices = jax.devices()
    n = tp * dp * pp
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    arr = np.array(devices[:n]).reshape(dp, pp, tp)
    return Mesh(arr, axis_names=("dp", "pp", "tp"))


# PartitionSpecs for the stacked layer weights [L, ...]. The leading L axis is
# split over "pp" (contiguous layer blocks per stage, the reference's
# GptNeoXDecoder.cc:94-120 layout); a size-1 pp axis makes it a no-op.
LAYER_SPECS = {
    "ln1_w": P("pp"),
    "ln1_b": P("pp"),
    "qkv_w": P("pp", None, "tp"),  # [L, H, nH*3*dh] heads-major flat — head split
    "qkv_b": P("pp", "tp"),
    "proj_w": P("pp", "tp", None),  # [L, nH*dh, H] — row split
    "proj_b": P("pp"),
    "ln2_w": P("pp"),
    "ln2_b": P("pp"),
    "up_w": P("pp", None, "tp"),  # [L, H, I]
    "up_b": P("pp", "tp"),
    "down_w": P("pp", "tp", None),  # [L, I, H]
    "down_b": P("pp"),
    "gate_w": P("pp", None, "tp"),  # [L, H, I] SwiGLU gate — column split like up
    # --- MoE (Mixtral family): EXPERT PARALLELISM over the tp axis ---
    # Each device holds E/tp whole experts; the batched expert GEMMs
    # (ops/moe.py einsums over the E axis) stay device-local and XLA derives
    # the token dispatch/combine collectives from the einsum structure —
    # the GSPMD form of the reference's expert-parallel MoE
    # (src/fastertransformer/kernels/moe_kernels.cu + its EP plumbing).
    "router_w": P("pp"),  # [L, H, E] — tiny, replicated
    "eup_w": P("pp", "tp", None, None),  # [L, E, H, I]
    "egate_w": P("pp", "tp", None, None),
    "edown_w": P("pp", "tp", None, None),  # [L, E, I, H]
}

TOP_SPECS = {
    "embed": P(),  # replicated (gather-heavy; small vs layer weights)
    "pos_embed": P(),  # learned absolute positions (gpt/starcoder families)
    "final_ln_w": P(),
    "final_ln_b": P(),
    "lm_head": P("tp", None),  # [V, H] vocab-split, like the reference's TP lm head
    "lm_head_b": P("tp"),  # GPT-J's biased head follows the vocab split
}


def _spec_for_quant(spec: P, qt: QuantizedTensor) -> P:
    """Scale spec derived from the weight spec.

    Per-output-channel scales (group_size=0) drop the contraction (K) axis.
    Group-wise scales keep a K-group axis in the K slot [L, K/G, N]; it
    inherits the weight K axis's sharding (group boundaries align with shard
    boundaries whenever K/tp is a multiple of G, which holds for every
    supported config — G=128 and hidden sizes are multiples of 128*tp)."""
    ndim = qt.q.ndim
    axes = list(spec) + [None] * (ndim - len(spec))
    if qt.group_size:
        return P(*axes)
    del axes[qt.k_axis % ndim]
    return P(*axes)


def param_shardings(config: GptNeoXConfig, params: Params, mesh: Mesh):
    """Build a NamedSharding pytree matching ``params``' structure."""

    def fix(spec):
        # tolerate user-built meshes without a "pp" axis
        if "pp" in mesh.shape:
            return spec
        return P(*[None if a == "pp" else a for a in spec])

    def leaf(spec, value):
        spec = fix(spec)
        if isinstance(value, QuantizedTensor):
            return QuantizedTensor(
                q=NamedSharding(mesh, spec),
                scale=NamedSharding(mesh, _spec_for_quant(spec, value)),
                k_axis=value.k_axis,
                bits=value.bits,
                group_size=value.group_size,
            )
        return NamedSharding(mesh, spec)

    def top_spec(name, value):
        if (
            name == "lm_head"
            and isinstance(value, QuantizedTensor)
            and value.k_axis % value.q.ndim == 0
        ):
            # int4 head stored transposed [H, V_pad]: vocab split is axis 1
            return P(None, "tp")
        return TOP_SPECS[name]

    def layer_spec(name):
        # "concat" fused-QKV ([q | k | v] with differing head counts) cannot
        # be expressed as one dim sharding — a flat tp-split would cut the
        # q/k/v segments unevenly. Replicate it (GQA models are the smaller
        # families); a per-segment split needs separate q/k/v weights.
        if name == "qkv_w" and config.qkv_layout == "concat":
            return P("pp", None, None)
        if name == "qkv_b" and config.qkv_layout == "concat":
            return P("pp", None)
        return LAYER_SPECS[name]

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {n: leaf(layer_spec(n), val) for n, val in v.items()}
        else:
            out[k] = leaf(top_spec(k, v), v)
    return out


def pad_vocab_for_tp(config: GptNeoXConfig, params: Params, mesh: Mesh) -> Params:
    """Pad the vocab-split LM head up to a multiple of the tp axis.

    The reference pads its vocab to x8xTP so the TP-split head GEMM tiles
    evenly (GptNeoX.cc:260-264 vocab_size_padded_); here a non-divisible
    vocab (e.g. CodeFuse's 100831 under tp=8) would fail NamedSharding's
    divisibility check outright. Zero rows are appended to ``lm_head`` (and
    ``lm_head_b``); models.gptneox.lm_logits slices logits back to
    ``vocab_size`` before any processor runs, so pad ids are unsampleable.
    The int4 transposed head already pads V to a 2560-multiple (divisible by
    every supported tp) and is left alone; ``embed`` is replicated and needs
    no padding."""
    tp = int(dict(mesh.shape).get("tp", 1))
    w = params.get("lm_head")
    if tp <= 1 or w is None:
        return params
    if isinstance(w, QuantizedTensor):
        if w.k_axis % w.q.ndim == 0:  # transposed int4 head: already padded
            return params
        V = w.q.shape[0]
        pad = (-V) % tp
        if pad == 0:
            return params
        out = dict(params)
        out["lm_head"] = QuantizedTensor(
            q=jnp.pad(w.q, ((0, pad), (0, 0))),
            scale=jnp.pad(w.scale, ((0, pad),)),
            k_axis=w.k_axis, bits=w.bits, group_size=w.group_size,
        )
    else:
        V = w.shape[0]
        pad = (-V) % tp
        if pad == 0:
            return params
        out = dict(params)
        out["lm_head"] = jnp.pad(w, ((0, pad), (0, 0)))
    if "lm_head_b" in out:
        out["lm_head_b"] = jnp.pad(params["lm_head_b"], ((0, pad),))
    return out


def shard_params(config: GptNeoXConfig, params: Params, mesh: Mesh) -> Params:
    params = pad_vocab_for_tp(config, params, mesh)
    shardings = param_shardings(config, params, mesh)

    def place(x, s):
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(
                q=jax.device_put(x.q, s.q),
                scale=jax.device_put(x.scale, s.scale),
                k_axis=x.k_axis,
                bits=x.bits,
                group_size=x.group_size,
            )
        return jax.device_put(x, s)

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {
                n: place(val, shardings[k][n]) for n, val in v.items()
            }
        else:
            out[k] = place(v, shardings[k])
    return out


def cache_sharding(mesh: Mesh) -> NamedSharding:
    """KV cache [L, B, nH, S, dh]: layers on pp, batch on dp, heads on tp."""
    if "pp" in mesh.shape:
        return NamedSharding(mesh, P("pp", "dp", "tp", None, None))
    return NamedSharding(mesh, P(None, "dp", "tp", None, None))


def pool_state_shardings(config: GptNeoXConfig, mesh: Mesh, state: dict):
    """NamedSharding pytree for a ContinuousBatcher's pool state.

    The serving-pool analog of the reference's TP-sharded engine state behind
    Triton (GptNeoXTritonModel.cc:29-38 instantiates one TP engine per node;
    NCCL TP runs inside every forward, GptNeoXOp.h:117-118): the KV slabs
    shard their kv-head axis over "tp" (and the layer axis over "pp"), while
    the per-slot bookkeeping arrays (tokens, lengths, sampling params, block
    tables) replicate — they are KB-sized and read by every shard.

    Dense slabs: k/v [L, B, nKV, S, dh], scales [L, B, nKV, S].
    Paged slabs: pk/pv [L, P, nKV, ps, dh], scales [L, P, nKV, ps].
    A kv-head count not divisible by the tp axis falls back to replicated
    slabs (GQA families with few KV heads) — correct, just not memory-scaled.
    """
    tp = int(dict(mesh.shape).get("tp", 1))
    has_pp = "pp" in mesh.shape
    heads_ok = config.kv_heads % tp == 0
    pp_ax = "pp" if has_pp else None
    tp_ax = "tp" if heads_ok else None

    def slab_spec(ndim):
        # [L, B/P, nKV, S/ps(, dh)] — layer axis 0, kv-head axis 2
        axes = [pp_ax, None, tp_ax, None, None][:ndim]
        return NamedSharding(mesh, P(*axes))

    repl = NamedSharding(mesh, P())

    def leaf(path, x):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if name in ("k", "v", "k4", "v4", "k_s", "v_s",
                    "pk", "pv", "pk4", "pv4", "pk_s", "pv_s"):
            return slab_spec(x.ndim)
        return repl

    return jax.tree_util.tree_map_with_path(leaf, state)
