"""Model load-speed benchmark — reference delta #5 ("higher model load
speed", /root/reference/README.md:36; multiprocess convert
huggingface_convert.py:141-149, C++ load-and-quantize memory_utils.cu:442-516).

Synthesizes CodeFuse-13B-shaped checkpoint dirs in the reference's .bin
layout (once; reused on re-runs), then measures end-to-end
``load_bin_checkpoint`` (disk -> host -> device, block_until_ready) for:

  - pre-quantized int4 (.q4.bin, ~6.3GB payload)   [serving headline config]
  - pre-quantized int8 (.q.bin, ~12.6GB payload)   [reference's int8 path]
  - fp16 + quantize-on-load (~25GB read + in-memory quantize)
  x {native C++ threaded preads, Python thread-pool fallback}

Cold cache: /proc/sys/vm/drop_caches is written between runs when permitted
(we usually run as root); otherwise numbers are page-cache-warm and labeled.

Usage:
  python tools/load_bench.py [--dir chiprun_out/load_bench] [--runs 2]
  python tools/load_bench.py --configs q4,q8   # skip the 25GB fp dir
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fastertransformer4codefuse_tpu.core.config import GptNeoXConfig  # noqa: E402


def _write(path, shape, dtype):
    if os.path.exists(path):
        return
    # zero pages write at full disk bandwidth and are loader-safe (amax=0
    # scales fall back to 1); values are irrelevant to load timing
    np.zeros(shape, dtype).tofile(path + ".tmp")
    os.rename(path + ".tmp", path)


def synth_dir(base: str, kind: str, cfg: GptNeoXConfig, group_size: int = 128):
    """Create a reference-layout checkpoint dir of the given kind
    ("fp" | "q8" | "q4")."""
    d = os.path.join(base, kind)
    os.makedirs(d, exist_ok=True)
    H, nH, dh, I, V, L = (
        cfg.hidden_size, cfg.head_num, cfg.size_per_head,
        cfg.inter_size, cfg.vocab_size, cfg.layer_num,
    )
    wdt = np.float16

    if not os.path.exists(os.path.join(d, "config.ini")):
        with open(os.path.join(d, "config.ini.tmp"), "w") as f:
            f.write(
                "[gptneox]\nmodel_name=codefuse-13b\nhead_num=%d\n"
                "size_per_head=%d\nvocab_size=%d\nnum_layer=%d\n"
                "rotary_embedding=%d\ninter_size=%d\nstart_id=%d\nend_id=%d\n"
                "use_gptj_residual=1\nweight_data_type=fp16\n"
                % (nH, dh, V, L, cfg.rotary_embedding_dim, I,
                   cfg.start_id, cfg.end_id)
            )
        os.rename(os.path.join(d, "config.ini.tmp"), os.path.join(d, "config.ini"))

    # shared fp tensors (embeddings/norms/biases) — present in every variant
    _write(os.path.join(d, "model.wte.bin"), (V * H,), wdt)
    _write(os.path.join(d, "model.lm_head.weight.bin"), (V * H,), wdt)
    _write(os.path.join(d, "model.final_layernorm.weight.bin"), (H,), wdt)
    _write(os.path.join(d, "model.final_layernorm.bias.bin"), (H,), wdt)
    for i in range(L):
        p = os.path.join(d, f"model.layers.{i}.")
        _write(p + "input_layernorm.weight.bin", (H,), wdt)
        _write(p + "input_layernorm.bias.bin", (H,), wdt)
        _write(p + "post_attention_layernorm.weight.bin", (H,), wdt)
        _write(p + "post_attention_layernorm.bias.bin", (H,), wdt)
        _write(p + "attention.query_key_value.bias.0.bin", (3 * H,), wdt)
        _write(p + "mlp.dense_h_to_4h.bias.0.bin", (I,), wdt)
        _write(p + "mlp.attention.bias.sum.bin", (H,), wdt)

        # the four GEMM weights: (name, K, N)
        gemms = [
            ("attention.query_key_value.weight", H, 3 * H),
            ("attention.dense.weight", nH * dh, H),
            ("mlp.dense_h_to_4h.weight", H, I),
            ("mlp.dense_4h_to_h.weight", I, H),
        ]
        for name, K, N in gemms:
            if kind == "fp":
                _write(p + name + ".0.bin", (K * N,), wdt)
            elif kind == "q8":
                _write(p + name + ".0.q.bin", (K * N,), np.int8)
                _write(p + name + ".0.s.bin", (N,), wdt)
            else:  # q4
                _write(p + name + ".0.q4.bin", (K // 2 * N,), np.int8)
                _write(p + name + f".0.s4g{group_size}.bin",
                       (K // group_size * N,), wdt)
    return d


def drop_caches() -> bool:
    try:
        os.sync()
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3")
        return True
    except OSError:
        return False


def dir_bytes(d: str) -> int:
    return sum(
        os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
    )


def measure(d: str, kind: str, native_io: bool, group_size: int):
    """Returns (read_s, total_s, cold): raw disk->host read phase timed alone
    (the part native IO accelerates), then the full disk->host->device load."""
    import jax

    import fastertransformer4codefuse_tpu.native as native
    from fastertransformer4codefuse_tpu.ckpt import loader
    from fastertransformer4codefuse_tpu.ckpt.loader import load_bin_checkpoint

    orig = native.available
    if not native_io:
        native.available = lambda: False
    try:
        cold = drop_caches()
        t0 = time.perf_counter()
        loader._bulk_read_dir(d, 16)
        read_s = time.perf_counter() - t0

        cold = drop_caches() and cold
        t0 = time.perf_counter()
        cfg, params = load_bin_checkpoint(
            d,
            dtype="bf16",
            int8_mode=1,
            weight_bits=4 if kind == "q4" else 8,
            group_size=group_size if kind == "q4" else 0,
            quantize_embeddings=True,
        )
        jax.block_until_ready(params)
        total_s = time.perf_counter() - t0
        del params
    finally:
        native.available = orig
    return read_s, total_s, cold


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="chiprun_out/load_bench")
    ap.add_argument("--configs", default="q4,q8,fp")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (0 = full 13B; use 2 for smoke)")
    args = ap.parse_args()

    cfg = GptNeoXConfig.codefuse_13b()
    if args.layers:
        cfg = GptNeoXConfig(**{**cfg.__dict__, "layer_num": args.layers})
    results = []
    for kind in args.configs.split(","):
        t0 = time.time()
        d = synth_dir(args.dir, kind, cfg, args.group_size)
        gb = dir_bytes(d) / 1e9
        print(f"# {kind}: dir ready in {time.time()-t0:.1f}s, {gb:.1f} GB",
              flush=True)
        for native_io in (True, False):
            reads, totals = [], []
            cold = None
            for _ in range(args.runs):
                r, t, cold = measure(d, kind, native_io, args.group_size)
                reads.append(r)
                totals.append(t)
            rec = {
                "config": kind,
                "io": "native" if native_io else "python-fallback",
                "bytes_gb": round(gb, 2),
                "read_s": round(min(reads), 2),
                "read_gb_per_s": round(gb / min(reads), 2),
                "load_s": round(min(totals), 2),
                "gb_per_s": round(gb / min(totals), 2),
                "cache": "cold" if cold else "warm",
                "runs": [round(t, 2) for t in totals],
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)
    print("# summary")
    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
