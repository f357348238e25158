"""Probe: SmoothQuant W8A8 prefill vs weight-only int8 prefill (13B, card).

Prefill is compute-bound (M = B*S tokens wide), so the int8 x int8 tensor-
core rate (twice bf16) should show directly; decode stays weight-only
either way (ops/linear._A8_MIN_M). Times full generate(output_len=1) calls
(prefill + one step) and reports the delta.

Run: python tools/a8_prefill_probe.py --in_len 1024 [--case a|b]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--in_len", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--bits", type=int, default=8,
                    help="8 = W8A8 A/B; 4 = per-channel W4A8 A/B")
    ap.add_argument("--case", default="")
    args = ap.parse_args()

    if not args.case:
        import subprocess
        for case in "ab":
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--case", case]
                + [a for a in sys.argv[1:]],
                capture_output=True, text=True, timeout=3000,
            )
            print((r.stdout or "").strip() or f"# case {case} failed:\n"
                  + "\n".join((r.stderr or "").strip().splitlines()[-10:]),
                  flush=True)
        return

    from fastertransformer4codefuse_tpu import (
        GptNeoXConfig,
        GptNeoXEngine,
        RuntimeConfig,
        init_params,
    )
    import jax

    cfg = GptNeoXConfig.codefuse_13b()
    if args.layers:
        cfg = GptNeoXConfig(**{**cfg.__dict__, "layer_num": args.layers})
    params = init_params(
        cfg, dtype="bf16", int8_mode=1, quantize_embeddings=True,
        weight_bits=args.bits,
    )
    jax.block_until_ready(params)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(
            dtype="bf16", int8_mode=1, kv_cache_dtype="int8", seq_bucket=128,
            act_int8=(args.case == "b"),
        ),
    )
    prompt = [list(np.random.default_rng(0).integers(2, 50000, args.in_len))]
    eng.generate(prompt, output_len=1, top_k=1)  # compile
    t0 = time.perf_counter()
    for _ in range(args.reps):
        eng.generate(prompt, output_len=1, top_k=1)
    dt = (time.perf_counter() - t0) / args.reps * 1000
    wl = f"int{args.bits}"
    label = (f"b) W{args.bits}A8 (act_int8)" if args.case == "b"
             else f"a) weight-only {wl}")
    print(f"{label} prefill+1step @in={args.in_len}: {dt:.1f} ms", flush=True)


if __name__ == "__main__":
    main()
