"""Probe: prompt-lookup speculative decoding vs plain greedy at 13B.

Two workloads:
  - "repeat": a highly repetitive code-like token stream (the regime prompt
    lookup targets — boilerplate/copy-heavy completions);
  - "mixed": the repetitive prompt with a lower-match continuation
    (acceptance depends on what the model actually generates).

Plain greedy runs the engine's fully-jitted while_loop (no per-step host
sync); the printed tokens/step shows the machine-independent win, the tok/s
the net on the card it ran on.

Run: python tools/speculative_probe.py --out 256
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
    ap.add_argument("--in_len", type=int, default=512)
    ap.add_argument("--out", type=int, default=256)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1,
                    help=">1: run the batched loop on B prompt variants and "
                         "report aggregate tok/s")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--bits", type=int, default=4, help="8 = bit-matched int8 weights")
    ap.add_argument("--group", type=int, default=128)
    args = ap.parse_args()

    import jax

    from fastertransformer4codefuse_tpu import (
        GptNeoXConfig,
        GptNeoXEngine,
        RuntimeConfig,
        init_params,
    )
    from fastertransformer4codefuse_tpu.engine.speculative import (
        speculative_generate,
        speculative_generate_batched,
    )

    cfg = GptNeoXConfig.codefuse_13b()
    if args.layers:
        cfg = GptNeoXConfig(**{**cfg.__dict__, "layer_num": args.layers})
    params = init_params(
        cfg, dtype="bf16", int8_mode=1, weight_bits=args.bits,
        group_size=(args.group if args.bits == 4 else 0),
        quantize_embeddings=True,
    )
    jax.block_until_ready(params)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8",
                      seq_bucket=128),
    )

    rng = np.random.default_rng(0)
    phrase = list(rng.integers(2, 50000, size=32))
    repeat = (phrase * (args.in_len // 32 + 1))[: args.in_len]

    def timed_greedy(prompt):
        eng.generate([prompt], output_len=args.out, top_k=1)  # compile
        t0 = time.perf_counter()
        out = eng.generate([prompt], output_len=args.out, top_k=1)
        dt = time.perf_counter() - t0
        n = int(out.sequence_lengths[0, 0]) - len(prompt)
        return n / dt, [int(x) for x in out.output_ids[0, 0, : len(prompt) + n]]

    def timed_spec(prompt):
        # warm with the SAME output_len: the token buffer is bucketed by
        # total length, and a different bucket compiles a different program
        speculative_generate(eng, prompt, args.out, k=args.k)
        t0 = time.perf_counter()
        toks, stats = speculative_generate(eng, prompt, args.out, k=args.k)
        dt = time.perf_counter() - t0
        return (len(toks) - len(prompt)) / dt, toks, stats

    if args.batch > 1:
        # B distinct repetitive prompts (different phrases -> different
        # drafts, different accept lengths -> a real ragged-commit workload)
        prompts = []
        for b in range(args.batch):
            ph = list(rng.integers(2, 50000, size=32))
            prompts.append((ph * (args.in_len // 32 + 1))[: args.in_len])
        speculative_generate_batched(eng, prompts, args.out, k=args.k)  # compile
        t0 = time.perf_counter()
        outs, stats = speculative_generate_batched(eng, prompts, args.out, k=args.k)
        dt = time.perf_counter() - t0
        emitted = sum(st.emitted for st in stats)
        tps = sum(st.tokens_per_step for st in stats) / len(stats)
        print(
            f"batched B={args.batch}: {emitted / dt:.1f} tok/s aggregate "
            f"({emitted} tokens in {dt:.2f}s), mean {tps:.2f} tok/step, "
            f"iterations {stats[0].iterations} (slowest row)",
            flush=True,
        )
        return

    for name, prompt in (("repeat", repeat),):
        g_rate, g_toks = timed_greedy(prompt)
        s_rate, s_toks, st = timed_spec(prompt)
        # prefix match vs the engine's greedy: on RANDOM bf16 weights the
        # logits are near-uniform, so argmax tie-breaks between the engine's
        # flash/fused kernel schedule and the chunked verify program flip
        # early — the spec path is exact greedy OF ITS OWN program (pinned by
        # tests/test_speculative.py on CPU fp32); trained weights rarely tie
        match = 0
        for a, b in zip(s_toks, g_toks):
            if a != b:
                break
            match += 1
        print(
            f"{name}: greedy {g_rate:.1f} tok/s | spec {s_rate:.1f} tok/s "
            f"({s_rate / g_rate:.2f}x) | {st.tokens_per_step:.2f} tok/step, "
            f"accept {st.accepted}/{st.drafted}, "
            f"greedy-prefix-match {match}/{len(s_toks)} "
            f"(random-weight bf16 ties; CPU fp32 is token-exact)",
            flush=True,
        )


if __name__ == "__main__":
    main()
