"""Probe: paged KV pool vs dense slab pool on the card (13B).

Cases (each in its own subprocess, so each starts with the whole card):

  a) dense  B=slots S=seq
  b) paged  B=slots S=seq, same capacity — block-table decode kernel
  c) dense  B=wide  S=seq
  d) paged  B=wide  S=seq

The paged pool's capacity-equality claim: with num_pages = slots*S/ps + 1
(the +1 is the garbage page) case b holds exactly the same KV bytes as case
a. The HBM-scaling claim is arithmetic (printed): dense reserves
slots x S x ~410KB/token at 13B int8 regardless of occupancy; paged
allocates per admitted request.

Run: python tools/paged_pool_probe.py --slots 8 --wide 16 --seq 1024
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
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--wide", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=0, help="0 = full 13B")
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group", type=int, default=128)
    ap.add_argument("--page", type=int, default=256)
    ap.add_argument("--kv", default="int8", help="KV cache dtype (int8|int4)")
    ap.add_argument("--case", default="")
    args = ap.parse_args()

    if not args.case:
        import subprocess
        for case in "abcdefg":
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--case", case]
                + [a for a in sys.argv[1:]],
                capture_output=True, text=True, timeout=3000,
            )
            out = (r.stdout or "").strip()
            print(out or f"# case {case} failed:\n"
                  + "\n".join((r.stderr or "").strip().splitlines()[-12:]),
                  flush=True)
        return

    import jax

    from fastertransformer4codefuse_tpu import (
        GptNeoXConfig,
        GptNeoXEngine,
        RuntimeConfig,
        init_params,
    )
    from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher

    cfg = GptNeoXConfig.codefuse_13b()
    if args.layers:
        cfg = GptNeoXConfig(**{**cfg.__dict__, "layer_num": args.layers})
    params = init_params(
        cfg, dtype="bf16", int8_mode=1, weight_bits=args.bits,
        group_size=args.group, quantize_embeddings=True,
    )
    jax.block_until_ready(params)
    eng = GptNeoXEngine(
        cfg, params,
        RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype=args.kv,
                      seq_bucket=128),
    )

    def fresh_pool(slots, in_len=None, out_len=None, **kw):
        in_len = in_len or args.seq // 2
        out_len = out_len or args.seq // 2 - 2
        cb = ContinuousBatcher(
            eng, max_slots=slots, max_seq_len=args.seq, prompt_bucket=128,
            **kw,
        )
        rng = np.random.default_rng(0)
        for _ in range(slots):
            cb.submit(
                list(rng.integers(2, 50000, size=(in_len,))), out_len, top_k=1,
            )
        # admit + finish chunk prefills so every timed tick is a decode tick
        for _ in range(in_len // 128 + 2):
            cb.step()
        return cb

    def time_ticks(cb, label, slots):
        cb.step()  # compile
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            cb.step()
        dt = (time.perf_counter() - t0) / args.ticks * 1000
        print(f"{label}: {dt:.1f} ms/tick "
              f"({slots * 1000 / dt:.0f} tok/s aggregate)", flush=True)
        return dt

    def paged_kw(slots):
        n_pages = slots * args.seq // args.page + 1
        return dict(paged=dict(num_pages=n_pages, page_size=args.page))

    if args.case == "a":
        time_ticks(fresh_pool(args.slots), f"a) dense flash B={args.slots}",
                   args.slots)
    elif args.case == "b":
        time_ticks(fresh_pool(args.slots, **paged_kw(args.slots)),
                   f"b) paged flash B={args.slots}", args.slots)
    elif args.case == "c":
        time_ticks(fresh_pool(args.wide), f"c) dense B={args.wide} (auto-XLA)",
                   args.wide)
    elif args.case == "d":
        time_ticks(fresh_pool(args.wide, **paged_kw(args.wide)),
                   f"d) paged flash B={args.wide}", args.wide)
    elif args.case == "e":
        # page-level sharing: the SAME page budget that serves `slots` long
        # requests (slots*seq tokens) serves 4*slots SHORT requests
        # concurrently — one pool adapts to the mix, where dense slabs need
        # separate per-length pool classes (engine/server.MultiPoolServer)
        wide2 = 4 * args.slots
        cb = fresh_pool(
            wide2, in_len=args.page - 64, out_len=62, **paged_kw(args.slots)
        )
        time_ticks(cb, f"e) paged B={wide2} shorts, {args.slots}x{args.seq} "
                   "page budget", wide2)
    elif args.case == "f":
        # pipelined ticks: dispatch-before-fetch overlaps the host sync with
        # the next tick's compute (engine/batcher.py)
        time_ticks(fresh_pool(args.slots, pipeline_ticks=True),
                   f"f) dense flash B={args.slots} pipelined", args.slots)
    elif args.case in ("g", "h"):
        # one body, labeled by --kv: "h --kv int4 --wide 32" is the packed
        # int4-KV capacity demo (half the page bytes again — widths no other
        # cache mode fits)
        time_ticks(
            fresh_pool(args.wide, pipeline_ticks=True, **paged_kw(args.wide)),
            f"{args.case}) paged {args.kv}-KV flash B={args.wide} pipelined",
            args.wide,
        )
    else:
        raise SystemExit(f"unknown --case {args.case!r} (a-h)")


if __name__ == "__main__":
    main()
