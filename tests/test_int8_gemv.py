"""Interpret-mode coverage of the stacked int8 GEMV (ops/int8_gemv.py)
against the plain XLA weight-only GEMM, and its dispatch from linear()."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu import (
    GptNeoXConfig, GptNeoXEngine, RuntimeConfig, init_params,
)
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_array
from fastertransformer4codefuse_tpu.ops import linear as lin
from fastertransformer4codefuse_tpu.ops.int8_gemv import int8_gemv_stacked, supported
from fastertransformer4codefuse_tpu.ops.routes import Routes


@pytest.mark.parametrize(
    "M,K,N", [(1, 512, 768), (4, 256, 512), (16, 384, 384), (8, 1024, 256)]
)
def test_int8_gemv_matches_xla(M, K, N):
    rng = np.random.default_rng(M)
    L = 3
    qt = quantize_array(jnp.asarray(rng.standard_normal((L, K, N)) * 0.02, jnp.float32))
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.float32)
    got = int8_gemv_stacked(x, qt.q, qt.scale, jnp.int32(2), interpret=True)
    want = lin.quantized_matmul_xla(x, qt[2])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "M,K,N,ok",
    [(1, 5120, 15360, True), (4, 20480, 5120, True), (17, 5120, 5120, False),
     (1, 100, 256, False), (1, 256, 200, False)],
)
def test_int8_gemv_gate(M, K, N, ok):
    assert supported(M, K, N) is ok


def test_engine_with_int8_gemv_matches_xla():
    """A decode run through the GEMV (interpret mode) gives the XLA path's
    greedy tokens; prefill widths stay on XLA's GEMM."""
    from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params

    cfg = GptNeoXConfig.tiny(head_num=8, size_per_head=32, inter_size=512, vocab_size=96)
    params = quantize_params(init_params(cfg, dtype="fp32"))
    eng = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", int8_mode=1, seq_bucket=8))
    prompts = [list(range(3, 12)), [9, 8]]  # prefill width 16: M = 32 rows
    want = eng.generate(prompts, output_len=6, top_k=1, return_cum_log_probs=True)
    calls = []
    real = int8_gemv_stacked

    def spy(x, *a, **k):
        calls.append(x.shape[0])
        return real(x, *a, **k)

    eng2 = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", int8_mode=1, seq_bucket=8))
    eng2.routes = Routes(int8_gemv=True, interpret=True)
    try:
        import fastertransformer4codefuse_tpu.ops.int8_gemv as g

        g.int8_gemv_stacked, saved = spy, g.int8_gemv_stacked
        got = eng2.generate(prompts, output_len=6, top_k=1, return_cum_log_probs=True)
    finally:
        g.int8_gemv_stacked = saved
    assert calls and max(calls) <= 2  # decode rows only
    np.testing.assert_array_equal(got.output_ids, want.output_ids)
    np.testing.assert_allclose(got.cum_log_probs, want.cum_log_probs, atol=1e-4)
