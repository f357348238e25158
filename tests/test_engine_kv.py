"""INT8 KV cache: engine outputs must stay close to the bf16-cache engine
(feature beyond the reference: it has no KV quantization, SURVEY §5
long-context section)."""
import numpy as np
import pytest

from fastertransformer4codefuse_tpu import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    init_params,
)


def test_int8_kv_cache_close():
    cfg = GptNeoXConfig.tiny(head_num=8, size_per_head=8, vocab_size=128)
    params = init_params(cfg, dtype="fp32")
    prompts = [[3, 4, 5, 17, 2, 9], [9, 8, 7]]
    ref = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=4)).generate(
        prompts, output_len=5, top_k=1, return_cum_log_probs=True
    )
    q = GptNeoXEngine(
        cfg, params, RuntimeConfig(dtype="fp32", kv_cache_dtype="int8", seq_bucket=4)
    ).generate(prompts, output_len=5, top_k=1, return_cum_log_probs=True)
    # int8 KV introduces small noise; greedy tokens on a tiny random model may
    # diverge late but the first generated token must match and cum_log_probs stay close
    assert ref.output_ids[0, 0, 6] == q.output_ids[0, 0, 6]
    assert ref.output_ids[1, 0, 3] == q.output_ids[1, 0, 3]
    np.testing.assert_allclose(ref.cum_log_probs, q.cum_log_probs, atol=0.5)


def test_int4_kv_pack_roundtrip():
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu.engine.kv_cache import (
        _pack_seq_pairs,
        _unpack_seq_pairs,
    )

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(-8, 8, (3, 10, 16)), jnp.int8)
    packed = _pack_seq_pairs(q)
    assert packed.shape == (3, 5, 16)
    np.testing.assert_array_equal(np.asarray(_unpack_seq_pairs(packed)), np.asarray(q))


def test_int4_kv_decode_write_rmw():
    """Decode writes at even/odd positions must not clobber the neighbor
    nibble: write pos 4 then 5 and recover both vectors exactly."""
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu.engine import kv_cache as kvc

    cfg = GptNeoXConfig.tiny(head_num=2, size_per_head=8, vocab_size=32)
    cache = kvc.init_cache(cfg, batch=1, max_seq_len=8, dtype="int4")
    rng = np.random.default_rng(1)
    k4 = jnp.asarray(rng.standard_normal((1, 1, 2, 8)), jnp.float32)
    v4 = jnp.asarray(rng.standard_normal((1, 1, 2, 8)), jnp.float32)
    k5 = jnp.asarray(rng.standard_normal((1, 1, 2, 8)), jnp.float32)
    v5 = jnp.asarray(rng.standard_normal((1, 1, 2, 8)), jnp.float32)
    cache = kvc.write_decode(cache, 0, k4, v4, jnp.asarray([4], jnp.int32))
    cache = kvc.write_decode(cache, 0, k5, v5, jnp.asarray([5], jnp.int32))
    got = kvc._unpack_seq_pairs(cache["k4"][0, 0])  # [nH, S, dh]
    scale = np.asarray(cache["k_s"][0, 0], np.float32)  # [nH, S]
    for pos, ref in ((4, k4), (5, k5)):
        deq = np.asarray(got[:, pos], np.float32) * scale[:, pos][:, None]
        err = np.abs(deq - np.asarray(ref[0, 0], np.float32)).max()
        amax = np.abs(np.asarray(ref)).max()
        assert err <= amax / 7.0 * 0.5 + 1e-6, (pos, err)


def _kv_mode_engine_close(mode, atol):
    cfg = GptNeoXConfig.tiny(head_num=8, size_per_head=8, vocab_size=128)
    params = init_params(cfg, dtype="fp32")
    prompts = [[3, 4, 5, 17, 2, 9], [9, 8, 7]]
    ref = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=4)).generate(
        prompts, output_len=5, top_k=1, return_cum_log_probs=True
    )
    q = GptNeoXEngine(
        cfg, params, RuntimeConfig(dtype="fp32", kv_cache_dtype=mode, seq_bucket=4)
    ).generate(prompts, output_len=5, top_k=1, return_cum_log_probs=True)
    assert ref.output_ids[0, 0, 6] == q.output_ids[0, 0, 6]
    assert ref.output_ids[1, 0, 3] == q.output_ids[1, 0, 3]
    np.testing.assert_allclose(ref.cum_log_probs, q.cum_log_probs, atol=atol)


def test_int4_kv_cache_engine_close():
    _kv_mode_engine_close("int4", atol=1.0)


def test_int8k_int4v_kv_cache_engine_close():
    _kv_mode_engine_close("int8k_int4v", atol=0.8)


def test_int4_kv_flash_decode_matches_xla():
    """Packed-slab flash kernel (interpret mode) vs the XLA unpack path."""
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu.engine import kv_cache as kvc
    from fastertransformer4codefuse_tpu.ops.flash_decode import flash_decode_stacked

    rng = np.random.default_rng(0)
    L, B, nH, S, dh = 2, 1, 8, 640, 128
    cache = {
        "k4": jnp.asarray(rng.integers(-128, 128, (L, B, nH, S // 2, dh)), jnp.int8),
        "v4": jnp.asarray(rng.integers(-128, 128, (L, B, nH, S // 2, dh)), jnp.int8),
        "k_s": jnp.asarray(rng.random((L, B, nH, S)) * 0.02, jnp.bfloat16),
        "v_s": jnp.asarray(rng.random((L, B, nH, S)) * 0.02, jnp.bfloat16),
    }
    q = jnp.asarray(rng.standard_normal((B, nH, dh)), jnp.bfloat16)
    sm = 1.0 / float(np.sqrt(dh))
    for pos in (15, 500):
        positions = jnp.asarray([pos], jnp.int32)
        valid = jnp.arange(S)[None, :] <= positions[:, None]
        ref = kvc.attend_decode(cache, jnp.int32(1), q, valid, sm, positions=positions)
        out = flash_decode_stacked(
            q, cache["k4"], cache["k_s"], cache["v4"], cache["v_s"],
            jnp.int32(1), positions, sm_scale=sm, bs=256, interpret=True,
        )
        err = jnp.max(jnp.abs(out.astype(jnp.float32) - ref.astype(jnp.float32)))
        assert float(err) < 0.05, (pos, float(err))


def test_cum_log_probs_optional_contract():
    """return_cum_log_probs defaults OFF at the engine level (the reference
    op's contract: codefuse_example.py:560 return_cum_log_probs=0 skips the
    full-vocab softmax pass, sampling_topk_kernels.cu:271-292). Tokens must be
    identical either way; the off path returns zeros."""
    cfg = GptNeoXConfig.tiny(head_num=8, size_per_head=8, vocab_size=128)
    params = init_params(cfg, dtype="fp32")
    prompts = [[3, 4, 5, 17, 2, 9], [9, 8, 7]]
    eng = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=4))
    off = eng.generate(prompts, output_len=5, top_k=1)
    on = eng.generate(prompts, output_len=5, top_k=1, return_cum_log_probs=True)
    np.testing.assert_array_equal(off.output_ids, on.output_ids)
    np.testing.assert_array_equal(off.cum_log_probs, 0.0)
    assert (np.asarray(on.cum_log_probs) < 0.0).all()
    # sampled path too (gumbel draw must be unaffected by the lp computation)
    off_s = eng.generate(prompts, output_len=5, top_k=4, random_seed=[3, 4])
    on_s = eng.generate(
        prompts, output_len=5, top_k=4, random_seed=[3, 4],
        return_cum_log_probs=True,
    )
    np.testing.assert_array_equal(off_s.output_ids, on_s.output_ids)


@pytest.mark.parametrize("quantized", [False, True])
def test_gpu_route_gates(quantized, monkeypatch):
    """On a GPU backend the engine turns on the decode kernel and the int8
    GEMV, and cuDNN prefill only behind float projections; on the CPU and
    under a mesh they stay off. Each engine keeps its own choice."""
    import jax

    from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params
    from fastertransformer4codefuse_tpu.ops import routes
    from fastertransformer4codefuse_tpu.parallel.sharding import build_mesh

    cfg = GptNeoXConfig.tiny()
    params = init_params(cfg, dtype="fp32")
    if quantized:
        params = quantize_params(params)
    cpu = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32"))
    assert cpu.routes == routes.Routes()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    gpu = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32"))
    assert gpu.routes.flash_decode and gpu.routes.int8_gemv
    assert gpu.routes.flash_prefill is (not quantized)
    off = GptNeoXEngine(cfg, params, RuntimeConfig(
        dtype="fp32", use_flash_decode=False, use_flash_prefill=False))
    assert not off.routes.flash_decode and not off.routes.flash_prefill
    tp = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32"), mesh=build_mesh(tp=2))
    # custom calls GSPMD cannot split
    assert not tp.routes.flash_decode and not tp.routes.int8_gemv
    assert gpu.routes.flash_decode and cpu.routes == routes.Routes()
    assert routes.current() == routes.Routes()  # nothing leaks outside a trace
