"""Profile the 13B decode step on the card via a profiler trace summary.

Prints the flat per-op device-time table for a short greedy run, the measured
per-step time, and the derived tokens/sec. Usage:

  python tools/profile_decode.py [--bits 4] [--group 128] [--in 1024] [--out 64]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from fastertransformer4codefuse_tpu.utils.compile_cache import enable as _cc
_cc()  # persistent XLA cache: recompiles of unchanged programs become instant


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group", type=int, default=128)
    ap.add_argument("--in", dest="in_len", type=int, default=1024)
    ap.add_argument("--out", dest="out_len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--trace-dir", default="chiprun_out/trace_decode")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--no-trace", action="store_true")
    args = ap.parse_args()

    import jax

    from fastertransformer4codefuse_tpu import (
        GptNeoXConfig,
        GptNeoXEngine,
        RuntimeConfig,
        init_params,
    )
    from fastertransformer4codefuse_tpu.utils.profiling import summarize_trace, trace

    cfg = GptNeoXConfig.codefuse_13b()
    params = init_params(
        cfg, dtype="bf16", int8_mode=1, quantize_embeddings=True, weight_bits=args.bits,
        group_size=args.group,
    )
    jax.block_until_ready(params)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8", seq_bucket=128),
    )
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50000, size=(args.batch, args.in_len)).tolist()

    def run():
        t0 = time.perf_counter()
        out = eng.generate(ids, output_len=args.out_len, top_k=1, min_length=args.out_len)
        dt = time.perf_counter() - t0
        return out, dt

    out2_len = max(args.out_len // 2, 1)
    run()  # compile + warm the out_len config
    eng.generate(ids, output_len=out2_len, top_k=1, min_length=out2_len)  # warm out2
    out, dt = run()
    t0 = time.perf_counter()
    eng.generate(ids, output_len=out2_len, top_k=1, min_length=out2_len)
    dt2 = time.perf_counter() - t0
    step_ms = (dt - dt2) / (args.out_len - out2_len) * 1000
    print(f"total {dt*1000:.1f}ms; per-step {step_ms:.2f}ms -> {1000/step_ms:.1f} tok/s (decode-only)")
    print(f"end-to-end tok/s incl prefill: {args.out_len/dt:.1f}")

    if not args.no_trace:
        os.makedirs(args.trace_dir, exist_ok=True)
        with trace(args.trace_dir):
            run()
        n_steps = args.out_len
        print(f"\nper-op device time (over {n_steps} steps + prefill):")
        for name, ms, count, snippet in summarize_trace(args.trace_dir, top=args.top):
            print(f"  {ms:9.2f}ms  x{count:5d}  {ms/n_steps*1000:8.1f}us/step  {name[:60]}  {snippet[:60]}")


if __name__ == "__main__":
    main()
