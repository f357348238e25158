"""Serving pool under device meshes (VERDICT r4 item 1).

The north-star serving scenario is continuous batching with TP-sharded
weights + KV: the reference serves its TP engine behind Triton with NCCL TP
inside every forward (triton_backend/gptneox/GptNeoXTritonModel.cc:29-38,
GptNeoXOp.h:117-118, GptNeoXDecoder.cc:342-360). Here the pool rides the
engine's GSPMD mesh: params shard per parallel/sharding.LAYER_SPECS, the
pool's KV slabs shard kv-heads over "tp" (layers over "pp"), and every pooled
request must emit exactly the tokens the unsharded one-shot engine emits.
"""
import jax
import numpy as np
import pytest

from fastertransformer4codefuse_tpu import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    init_params,
)
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu.parallel.sharding import build_mesh

PROMPTS = [[3, 4, 5], [9, 8, 7, 6, 5], [11, 12], [20, 21, 22, 23], [30, 31, 32]]
OUT_LENS = [5, 4, 6, 3, 5]


def _cfg(layer_num=2):
    return GptNeoXConfig.tiny(
        head_num=8, size_per_head=8, vocab_size=64, layer_num=layer_num
    )


def _refs(cfg, params, sampling=None):
    """Greedy (or sampled) one-shot outputs from an UNSHARDED engine."""
    eng = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=8))
    refs = []
    for i, (p, ol) in enumerate(zip(PROMPTS, OUT_LENS)):
        kw = dict(top_k=1) if sampling is None else sampling[i]
        o = eng.generate([p], output_len=ol, **kw)
        n = int(o.sequence_lengths[0, 0])
        refs.append([int(x) for x in o.output_ids[0, 0, :n]])
    return refs


def _run_pool(cb, sampling=None):
    uids = []
    for i, (p, ol) in enumerate(zip(PROMPTS, OUT_LENS)):
        kw = dict(top_k=1) if sampling is None else sampling[i]
        uids.append(cb.submit(p, ol, **kw))
    done = cb.run(max_ticks=300)
    return [done[u] for u in uids]


def _assert_parity(results, refs):
    for i, (r, ref) in enumerate(zip(results, refs)):
        assert r.done, f"request {i} never finished"
        assert r.output_ids == ref, f"req {i}: {r.output_ids} != {ref}"


def test_dense_pool_tp4_matches_unsharded_oneshot():
    cfg = _cfg()
    params = init_params(cfg, dtype="fp32")
    refs = _refs(cfg, params)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", seq_bucket=8, tensor_para_size=4),
        mesh=build_mesh(tp=4),
    )
    cb = ContinuousBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=8)
    # the KV slabs must actually shard their kv-head axis over "tp"
    spec = cb._state["cache"]["k"].sharding.spec
    assert spec[2] == "tp", f"pool KV slab not head-sharded: {spec}"
    _assert_parity(_run_pool(cb), refs)


def test_dense_pool_tp4_heterogeneous_sampling():
    """Per-slot heterogeneous sampling params under the sharded vocab head:
    the lm_head is tp-split over V, so sampling runs on collectives-assembled
    logits — must still match the unsharded engine token-for-token."""
    cfg = _cfg()
    params = init_params(cfg, dtype="fp32")
    sampling = [
        dict(top_k=1),
        dict(top_k=4, random_seed=7, temperature=0.8, repetition_penalty=1.3),
        dict(top_k=1),
        dict(top_k=8, random_seed=123, presence_penalty=0.5, min_length=2),
        dict(top_k=1),
    ]
    refs = _refs(cfg, params, sampling=sampling)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", seq_bucket=8, tensor_para_size=4),
        mesh=build_mesh(tp=4),
    )
    cb = ContinuousBatcher(eng, max_slots=3, max_seq_len=32, prompt_bucket=8)
    _assert_parity(_run_pool(cb, sampling=sampling), refs)


def test_paged_pool_tp4_matches_unsharded_oneshot():
    cfg = _cfg()
    params = init_params(cfg, dtype="fp32")
    refs = _refs(cfg, params)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", seq_bucket=8, tensor_para_size=4),
        mesh=build_mesh(tp=4),
    )
    cb = ContinuousBatcher(
        eng, max_slots=2, max_seq_len=32, prompt_bucket=8,
        paged=dict(num_pages=9, page_size=8),
    )
    spec = cb._state["cache"]["pk"].sharding.spec
    assert spec[2] == "tp", f"page-pool slab not head-sharded: {spec}"
    _assert_parity(_run_pool(cb), refs)


def test_paged_pool_tp2_int8_kv_matches_unsharded_pool():
    """Quantized KV pages under TP: int8 per-vector scales shard with the
    kv-head axis. Reference = the UNSHARDED pool with the identical paged
    int8 cache and chunk schedule, so the only delta is the mesh — the
    sharding must be numerically invisible through the quantize/dequantize
    round trips. (One-shot-vs-pool int8 parity is covered unsharded in
    test_paged_batcher.py; crossing prefill schedules AND reduction orders
    at once lands on int8 rounding boundaries.)"""
    cfg = _cfg()
    params = init_params(cfg, dtype="fp32")
    rt = lambda tp: RuntimeConfig(  # noqa: E731
        dtype="fp32", seq_bucket=8, tensor_para_size=tp, kv_cache_dtype="int8"
    )
    paged = dict(num_pages=9, page_size=8)
    eng0 = GptNeoXEngine(cfg, params, rt(1))
    cb0 = ContinuousBatcher(
        eng0, max_slots=2, max_seq_len=32, prompt_bucket=8, paged=dict(paged)
    )
    refs = [r.output_ids for r in _run_pool(cb0)]

    eng = GptNeoXEngine(cfg, params, rt(2), mesh=build_mesh(tp=2))
    cb = ContinuousBatcher(
        eng, max_slots=2, max_seq_len=32, prompt_bucket=8, paged=dict(paged)
    )
    assert cb._state["cache"]["pk_s"].sharding.spec[2] == "tp"
    _assert_parity(_run_pool(cb), refs)


def test_dense_pool_tp2_pp2_matches_unsharded_oneshot():
    """TP x PP pool: chunk prefill and decode ticks route through
    parallel.pipeline (ppermute stage ring), layers shard over "pp"."""
    cfg = _cfg(layer_num=4)
    params = init_params(cfg, dtype="fp32")
    refs = _refs(cfg, params)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", seq_bucket=8, tensor_para_size=2),
        mesh=build_mesh(tp=2, pp=2),
    )
    cb = ContinuousBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=8)
    spec = cb._state["cache"]["k"].sharding.spec
    assert spec[0] == "pp" and spec[2] == "tp", spec
    _assert_parity(_run_pool(cb), refs)


def test_int8_weights_pool_tp2_matches_unsharded_oneshot():
    """QuantizedTensor params under the pooled TP path (the reference's
    int8_mode=1 serving config, GptNeoXTritonModel + CUTLASS fpA-intB)."""
    cfg = _cfg()
    params = quantize_params(init_params(cfg, dtype="fp32"))
    refs = []
    eng0 = GptNeoXEngine(
        cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=8, int8_mode=1)
    )
    for p, ol in zip(PROMPTS, OUT_LENS):
        o = eng0.generate([p], output_len=ol, top_k=1)
        n = int(o.sequence_lengths[0, 0])
        refs.append([int(x) for x in o.output_ids[0, 0, :n]])
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", seq_bucket=8, int8_mode=1, tensor_para_size=2),
        mesh=build_mesh(tp=2),
    )
    cb = ContinuousBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=8)
    _assert_parity(_run_pool(cb), refs)


def test_pool_tick_single_psum_per_layer_tp4():
    """The pool's decode tick keeps the reference's one-all-reduce-per-layer
    structure under TP (GptNeoXDecoder.cc:342-360): the compiled SPMD tick
    contains exactly layer_num all-reduces over the hidden dim plus the
    lm-head logits assembly — no per-projection reductions snuck in."""
    cfg = _cfg(layer_num=2)
    params = init_params(cfg, dtype="fp32")
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", seq_bucket=8, tensor_para_size=4),
        mesh=build_mesh(tp=4),
    )
    cb = ContinuousBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=8)
    step = cb._build_step()
    compiled = (
        jax.jit(step)
        .lower(eng.params, cb._state)
        .compile()
    )
    hlo = compiled.as_text()
    n_ar = hlo.count("all-reduce(") + hlo.count("all-reduce-start(")
    # layer psums (= layer_num) + up to a couple for logits/sampling assembly
    assert cfg.layer_num <= n_ar <= cfg.layer_num + 3, (
        f"expected ~{cfg.layer_num} per-layer all-reduces, found {n_ar}"
    )


def test_paged_pool_pp_rejected():
    cfg = _cfg(layer_num=4)
    params = init_params(cfg, dtype="fp32")
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", seq_bucket=8, tensor_para_size=2),
        mesh=build_mesh(tp=2, pp=2),
    )
    with pytest.raises(AssertionError, match="paged pools under pipeline"):
        ContinuousBatcher(
            eng, max_slots=2, max_seq_len=32, prompt_bucket=8,
            paged=dict(num_pages=9, page_size=8),
        )


def test_spec_pool_tp4_matches_unsharded_oneshot():
    """Pooled SPECULATIVE decoding under TP: the (k+1)-wide verify tick runs
    through the sharded prefill_chunk program (one all-reduce per layer) and
    every commit must equal the unsharded one-shot greedy output."""
    from fastertransformer4codefuse_tpu.engine.spec_pool import SpecPool

    cfg = _cfg()
    params = init_params(cfg, dtype="fp32")
    refs = _refs(cfg, params)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", seq_bucket=8, tensor_para_size=4),
        mesh=build_mesh(tp=4),
    )
    cb = SpecPool(eng, k=4, ngram=2, max_slots=2, max_seq_len=32,
                  prompt_bucket=8)
    spec = cb._state["cache"]["k"].sharding.spec
    assert spec[2] == "tp", f"spec-pool KV slab not head-sharded: {spec}"
    _assert_parity(_run_pool(cb), refs)


@pytest.mark.parametrize("int8_mode,kv,tp,off", [
    (1, None, 2, True), (1, "int8", 2, True), (0, "int8", 2, False), (1, "int8", 0, False),
])
def test_sharded_int8_engine_compiles_without_triton_gemm(int8_mode, kv, tp, off, monkeypatch):
    """On the GPU a sharded engine with int8 weights compiles its programs
    without XLA's Triton GEMMs (they computed NaN in the chunked prefill of a
    TP=4 engine on the cards), and serves pools under the mesh; one-card
    engines and bf16 weights with an int8 KV cache keep the default compiler
    options."""
    cfg = GptNeoXConfig.tiny(head_num=4, size_per_head=8, vocab_size=64)
    params = init_params(cfg, dtype="fp32")
    if int8_mode:
        params = quantize_params(params)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="fp32", int8_mode=int8_mode, kv_cache_dtype=kv, seq_bucket=8),
        mesh=build_mesh(tp=tp) if tp else None,
    )
    want = {"xla_gpu_enable_triton_gemm": False} if off else {}
    assert eng.compiler_options == want
    if tp:
        ContinuousBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=8)


@pytest.mark.parametrize("mode", ["single", "batched", "pool"])
def test_speculation_under_mesh_refused_on_gpu(mode, monkeypatch):
    """Speculative decoding (one-shot and pooled) was not run under a mesh on
    the cards: refused under a multi-device mesh on the GPU, served on one
    card."""
    import jax

    from fastertransformer4codefuse_tpu.engine.spec_pool import SpecPool
    from fastertransformer4codefuse_tpu.engine.speculative import (
        speculative_generate, speculative_generate_batched,
    )

    cfg = _cfg()
    params = init_params(cfg, dtype="fp32")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    one = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=8))
    tp = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=8),
                       mesh=build_mesh(tp=2))
    for eng in (one, tp):
        run = {
            "single": lambda: speculative_generate(eng, PROMPTS[0], 0),
            "batched": lambda: speculative_generate_batched(eng, [PROMPTS[0]], 0),
            "pool": lambda: SpecPool(eng, k=2, ngram=2, max_slots=2, max_seq_len=32,
                                     prompt_bucket=8),
        }[mode]
        if eng is tp:
            with pytest.raises(NotImplementedError):
                run()
        else:
            run()
