"""Collective structure of the sharded decode step, read from compiled HLO.

The reference all-reduces once per layer under the parallel residual
(GptNeoXDecoder.cc:342-360) and hands activations between pipeline stages at
block edges (GptNeoXDecoder.cc:252-265). Under GSPMD both properties are
visible in the compiled module of the 8-device host mesh the tests run on:

  - the TP decode layer keeps exactly ONE all-reduce, inside the scanned
    layer loop, and no other per-projection collective;
  - every pipeline stage edge lowers to a collective-permute.

On the GPU the same module hands these collectives to NCCL; whether their
time overlaps compute is read from a profiler trace on the cards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastertransformer4codefuse_tpu import GptNeoXConfig, init_params
from fastertransformer4codefuse_tpu.models import gptneox as model
from fastertransformer4codefuse_tpu.models.params import QuantizedTensor
from fastertransformer4codefuse_tpu.parallel import pipeline
from fastertransformer4codefuse_tpu.parallel.sharding import (
    cache_sharding,
    pad_vocab_for_tp,
    param_shardings,
)


def _host_mesh(dp, pp, tp):
    from jax.sharding import Mesh

    devs = jax.devices()[: dp * pp * tp]
    return Mesh(np.array(devs).reshape(dp, pp, tp), ("dp", "pp", "tp"))


def _sds(tree, shardings):
    def to_sds(x, s):
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=s)

    def leaf(p, s):
        if isinstance(s, QuantizedTensor):
            return QuantizedTensor(
                q=to_sds(p.q, s.q), scale=to_sds(p.scale, s.scale),
                k_axis=p.k_axis, bits=p.bits, group_size=p.group_size,
            )
        return to_sds(p, s)

    return jax.tree.map(
        leaf, tree, shardings, is_leaf=lambda x: isinstance(x, QuantizedTensor)
    )


def _compile_decode(mesh, microbatches=0, dtype="bf16"):
    cfg = GptNeoXConfig.tiny(
        head_num=8, size_per_head=64, vocab_size=512, layer_num=4,
        inter_size=1024,
    )
    params = jax.eval_shape(
        lambda: pad_vocab_for_tp(cfg, init_params(cfg, dtype=dtype), mesh)
    )
    p_sds = _sds(params, param_shardings(cfg, params, mesh))
    B, S = 4, 256
    cache = jax.eval_shape(
        lambda: model.init_kv_cache(cfg, B, S, jnp.dtype(jnp.bfloat16 if dtype == "bf16" else jnp.float32))
    )
    cs = cache_sharding(mesh)
    c_sds = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=cs), cache
    )
    tok = jax.ShapeDtypeStruct((B,), jnp.int32)
    pos = jax.ShapeDtypeStruct((B,), jnp.int32)

    def step(params, tokens, positions, cache):
        if microbatches:
            h, cache = pipeline.decode_step(
                cfg, mesh, params, tokens, positions, cache,
                microbatches=microbatches,
            )
        else:
            h, cache = model.decode_step(cfg, params, tokens, positions, cache)
        return model.lm_logits(cfg, params, h), cache

    return jax.jit(step).lower(p_sds, tok, pos, c_sds).compile().as_text()


def test_pp_stage_edges_lower_to_collective_permutes_on_cpu8():
    mesh = _host_mesh(1, 2, 4)
    # float32: the CPU compiler cannot clone the pipeline's bf16 all-reduce
    hlo = _compile_decode(mesh, microbatches=2, dtype="fp32")
    n = sum(
        1 for ln in hlo.splitlines()
        if " collective-permute(" in ln or " collective-permute-start(" in ln
    )
    assert n >= 1, "no collective-permute on the pipeline stage edges"


def test_tp_decode_single_allreduce_per_layer_on_cpu8():
    mesh = _host_mesh(1, 1, 8)
    hlo = _compile_decode(mesh)
    # The whole module must carry exactly ONE all-reduce op — sitting inside
    # the scanned layer loop, so it launches once per layer (the reference's
    # single fused all-reduce, GptNeoXDecoder.cc:342-360): the attention-proj
    # and ffn-down partial sums are added before the reduction, and the
    # vocab-split logits need no collective because the output stays sharded.
    lines = hlo.splitlines()
    n_ar = sum(
        1 for ln in lines
        if (" all-reduce(" in ln or " all-reduce-start(" in ln)
    )
    assert n_ar == 1, f"expected exactly 1 all-reduce op, got {n_ar}"
    assert any(" while(" in ln for ln in lines), "layer scan loop missing"
    # and zero per-projection collectives of any other flavor
    for op in (" reduce-scatter(", " all-to-all("):
        assert not any(op in ln for ln in lines), f"unexpected {op} in decode"
