"""SmoothQuant (W8A8 — the reference's int8_mode=2 semantics): fold
exactness, the int8xint8 GEMM's accuracy, and the engine path end-to-end."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    init_params,
)
from fastertransformer4codefuse_tpu.ckpt.calibrate import collect_activation_stats
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu.ckpt.smoothquant import (
    apply_smoothquant_scaling,
    smoothquant_scales,
)
from fastertransformer4codefuse_tpu.models import gptneox as model
from fastertransformer4codefuse_tpu.ops import linear as lin


def calib_batches():
    rng = np.random.RandomState(0)
    return [[list(rng.randint(2, 60, size=12)) for _ in range(2)]]


def test_smoothquant_scales_balance():
    rng = np.random.RandomState(1)
    w = rng.randn(16, 8).astype(np.float32)
    amax = np.abs(rng.randn(16)).astype(np.float32) * 10
    s = smoothquant_scales(amax, w, alpha=0.5)
    assert s.shape == (16,)
    # scaled activation range == scaled weight range per channel (alpha=.5)
    a_over = amax / s
    w_over = np.abs(w).max(axis=1) * s
    np.testing.assert_allclose(a_over, w_over, rtol=1e-4)


@pytest.mark.parametrize("gated", [False, True])
def test_smoothquant_fold_is_fp_exact(gated):
    cfg = GptNeoXConfig.tiny(
        vocab_size=64,
        **(dict(norm="rmsnorm", gated_ffn=True, use_bias=False,
                use_gptj_residual=False, activation="silu") if gated else {}),
    )
    params = init_params(cfg, dtype="fp32")
    stats = collect_activation_stats(cfg, params, calib_batches(), jnp.float32)
    smoothed = apply_smoothquant_scaling(cfg, params, stats)

    ids = jnp.asarray(np.random.RandomState(2).randint(2, 60, size=(2, 9)), jnp.int32)
    lens = jnp.full((2,), 9, jnp.int32)
    c1 = model.init_kv_cache(cfg, 2, 9, jnp.float32)
    c2 = model.init_kv_cache(cfg, 2, 9, jnp.float32)
    h1, _ = model.prefill(cfg, params, ids, lens, c1)
    h2, _ = model.prefill(cfg, smoothed, ids, lens, c2)
    l1 = np.asarray(model.lm_logits(cfg, params, h1))
    l2 = np.asarray(model.lm_logits(cfg, smoothed, h2))
    np.testing.assert_allclose(l2, l1, atol=2e-4, rtol=1e-4)


def test_w8a8_matmul_accuracy():
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(32, 64), jnp.float32)
    wf = rng.randn(64, 48).astype(np.float32)
    scale = np.abs(wf).max(axis=0) / 127.0
    q = jnp.asarray(np.rint(wf / scale), jnp.int8)
    got = np.asarray(lin.w8a8_matmul(x, q, jnp.asarray(scale)))
    want = x @ wf
    err = np.abs(got - np.asarray(want)).max() / np.abs(want).max()
    assert err < 0.03, err


def test_act_int8_engine_matches_weight_only_closely():
    """int8_mode=1 + act_int8: prefill rides W8A8 (M >= _A8_MIN_M); the
    logits must stay close to the weight-only int8 engine's, and generation
    must complete. Greedy tokens compared on the smoothed model."""
    cfg = GptNeoXConfig.tiny(vocab_size=64)
    params = init_params(cfg, dtype="fp32")
    stats = collect_activation_stats(cfg, params, calib_batches(), jnp.float32)
    smoothed = apply_smoothquant_scaling(cfg, params, stats)
    qp = quantize_params(smoothed)

    prompt = [list(range(3, 20))]  # 17 tokens -> prefill M = 17 >= 16
    ref = GptNeoXEngine(
        cfg, qp, RuntimeConfig(dtype="fp32", int8_mode=1, seq_bucket=8)
    ).generate(prompt, output_len=6, top_k=1, return_cum_log_probs=True)
    out = GptNeoXEngine(
        cfg, qp,
        RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True, seq_bucket=8),
    ).generate(prompt, output_len=6, top_k=1, return_cum_log_probs=True)
    assert out.output_ids.shape == ref.output_ids.shape
    # same greedy continuation on this tame model; cum_log_probs close
    np.testing.assert_array_equal(ref.output_ids, out.output_ids)
    np.testing.assert_allclose(ref.cum_log_probs, out.cum_log_probs, atol=0.05)


def test_act_int8_decode_width_stays_weight_only():
    """Decode-width GEMMs (M < _A8_MIN_M) must NOT take the W8A8 path."""
    calls = []
    real = lin.w8a8_matmul

    def spy(x2d, *a, **k):
        calls.append(x2d.shape[0])
        return real(x2d, *a, **k)

    cfg = GptNeoXConfig.tiny(vocab_size=64)
    qp = quantize_params(init_params(cfg, dtype="fp32"))
    lin.w8a8_matmul = spy
    try:
        eng = GptNeoXEngine(
            cfg, qp,
            RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True,
                          seq_bucket=8),
        )
        eng.generate([list(range(3, 20))], output_len=4, top_k=1)
    finally:
        lin.w8a8_matmul = real
    assert calls, "prefill should have used W8A8"
    assert min(calls) >= lin._A8_MIN_M  # no decode-width (M=1) calls


def test_w4_stays_weight_only_under_act_int8():
    """int4 weights must NOT take the A8 path even with act_int8=True: the
    nibbles would be unpacked into a full [K, N] int8 copy per layer before
    the int8 dot (see ops/linear.py)."""
    calls = []
    real = lin.w8a8_matmul
    lin.w8a8_matmul = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    cfg = GptNeoXConfig.tiny(vocab_size=64)
    qp = quantize_params(init_params(cfg, dtype="fp32"), weight_bits=4,
                         group_size=0)
    try:
        eng = GptNeoXEngine(
            cfg, qp,
            RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True,
                          seq_bucket=8),
        )
        eng.generate([list(range(3, 20))], output_len=3, top_k=1)
    finally:
        lin.w8a8_matmul = real
    assert not calls
