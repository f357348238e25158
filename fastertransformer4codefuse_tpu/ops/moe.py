"""Mixture-of-Experts FFN: top-k routing + capacity-bucketed expert GEMMs.

The reference carries MoE kernels upstream (src/fastertransformer/kernels/
moe_kernels.cu — CUTLASS grouped GEMM behind a softmax router; never wired
into the CodeFuse/gptneox path). The formulation here is the
GShard/Switch lineage redesigned around static shapes:

  - router: fp32 softmax over E experts, top-k (Mixtral-style renormalized
    weights);
  - dispatch: tokens SORT by expert id (argsort is jit-static), each expert
    reads a contiguous [C, H] bucket gathered from the sorted order — no
    [T, E, C] one-hot tensors (whose memory is quadratic in tokens);
  - expert compute: ONE batched GEMM per projection over all experts
    ([E, C, H] @ [E, H, I] — the MXU sees E-many dense matmuls, and under
    expert parallelism the E axis shards over the mesh so each device runs
    only its experts' GEMMs, XLA inserting the dispatch/combine collectives
    from the einsum structure);
  - combine: scatter-add back to token order, weighted by the router.

Capacity: each expert bucket holds C = ceil(T * top_k / E * factor) slots.
Tokens beyond an expert's capacity lose that expert's contribution and the
surviving weights renormalize — standard inference-time behavior; factor
defaults to 2.0 (config.moe_capacity_factor), which makes drops negligible
at served batch shapes.
"""
from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp

from .linear import apply_act


def moe_ffn(
    x2d: jax.Array,  # [T, H]
    router_w: jax.Array,  # [H, E]
    egate_w,  # [E, H, I] or None (non-gated experts)
    eup_w: jax.Array,  # [E, H, I]
    edown_w: jax.Array,  # [E, I, H]
    top_k: int,
    capacity_factor: float,
    act: str = "silu",
    valid: jax.Array = None,  # [T] bool — False rows (padding / inactive
    # slots) route to a null expert id so they never consume capacity that
    # belongs to real tokens (their FFN output is zero; discarded anyway)
) -> jax.Array:
    T, H = x2d.shape
    E = router_w.shape[-1]
    k = top_k

    logits = jnp.dot(
        x2d.astype(jnp.float32), router_w.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    )  # [T, E]
    probs = jax.nn.softmax(logits, axis=-1)
    w, idx = jax.lax.top_k(probs, k)  # [T, k]
    w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    if valid is not None:
        # id E is out of range: one_hot rows are all-zero, so these entries
        # count toward no expert and sort past every real bucket
        idx = jnp.where(valid[:, None], idx, E)

    C = int(math.ceil(T * k / E * capacity_factor))
    C = min(max(C, 1), T * k)

    # ---- sort-based dispatch -------------------------------------------
    e_of = idx.reshape(T * k)  # expert of each (token, choice)
    order = jnp.argsort(e_of, stable=True)  # slots grouped by expert
    counts = jnp.sum(
        jax.nn.one_hot(e_of, E, dtype=jnp.int32), axis=0
    )  # [E]
    starts = jnp.cumsum(counts) - counts  # exclusive prefix
    slot_c = jnp.arange(C)[None, :]  # [1, C]
    take = jnp.clip(starts[:, None] + slot_c, 0, T * k - 1)  # [E, C]
    flat_slot = order[take]  # [E, C] index into (token, choice) space
    valid = slot_c < counts[:, None]  # [E, C]
    tok_of_slot = flat_slot // k  # [E, C]

    xe = jnp.take(x2d, tok_of_slot.reshape(-1), axis=0).reshape(E, C, H)
    xe = jnp.where(valid[..., None], xe, 0).astype(x2d.dtype)

    # ---- batched expert FFN (E local GEMMs; EP shards the E axis) ------
    up = jnp.einsum(
        "ech,ehi->eci", xe, eup_w.astype(xe.dtype),
        preferred_element_type=jnp.float32,
    )
    if egate_w is not None:
        g = jnp.einsum(
            "ech,ehi->eci", xe, egate_w.astype(xe.dtype),
            preferred_element_type=jnp.float32,
        )
        h = apply_act(g, act).astype(xe.dtype) * up.astype(xe.dtype)
    else:
        h = apply_act(up, act).astype(xe.dtype)
    ye = jnp.einsum(
        "eci,eih->ech", h, edown_w.astype(xe.dtype),
        preferred_element_type=jnp.float32,
    )  # [E, C, H] fp32

    # ---- weighted combine back to token order --------------------------
    w_of_slot = jnp.take(w.reshape(T * k), flat_slot.reshape(-1), axis=0)
    kept_w = jnp.where(valid.reshape(-1), w_of_slot, 0.0)
    contrib = ye.reshape(E * C, H) * kept_w[:, None]
    y = jnp.zeros((T, H), jnp.float32).at[tok_of_slot.reshape(-1)].add(
        contrib, mode="drop"
    )
    # renormalize over SURVIVING experts (capacity drops lose their weight)
    denom = jnp.zeros((T,), jnp.float32).at[tok_of_slot.reshape(-1)].add(
        kept_w, mode="drop"
    )
    y = y / jnp.maximum(denom, 1e-9)[:, None]
    return y.astype(x2d.dtype)
