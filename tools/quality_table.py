"""Quantization-quality table over the TRAINED proxy model.

Measures what the headline bench configs cost in model quality: held-out
byte-level NLL/perplexity and greedy-token agreement vs the fp32 engine, for
every weight precision the framework serves (int8, int4 per-channel,
int4 group-128, int4 group-128 + AWQ calibration), plus the int8-KV-cache
interaction. Writes the markdown table consumed by QUALITY.md.

The proxy (tools/train_proxy.py) is a 19M-param GPT-NeoX trained on this
repo's source text — the honest substitute for real CodeFuse weights in this
zero-egress environment (random weights lack the per-channel outliers that
make quantization hard; the reference's own quality claim is HumanEval on
trained weights, README.md:37-39).

  python tools/quality_table.py --ckpt chiprun_out/ftcf_proxy.npz --out QUALITY.md
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from train_proxy import config_of_ckpt, load_params, proxy_config


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="chiprun_out/ftcf_proxy.npz")
    ap.add_argument("--out", default="")
    ap.add_argument("--max-heldout", type=int, default=16384)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=48)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu import (
        GptNeoXEngine,
        RuntimeConfig,
    )
    from fastertransformer4codefuse_tpu.ckpt.calibrate import (
        apply_awq_scaling,
        collect_activation_stats,
    )
    from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params
    from quality_eval import eval_nll, greedy_agreement

    cfg = config_of_ckpt(args.ckpt)
    params = load_params(args.ckpt)
    held = np.load(args.ckpt + ".heldout.npy")[: args.max_heldout]
    print(f"held-out: {len(held)} bytes")

    # calibration prompts from the head of the held-out stream (disjoint from
    # the NLL tail below would be ideal; at byte level the overlap effect is
    # negligible and AWQ only reads activation amax, not labels)
    calib = [
        [held[i * 256 : (i + 1) * 256].tolist() for i in range(4)],
    ]
    nll_ids = held

    variants = {}
    variants["fp32"] = (params, 0, None)
    variants["int8"] = (quantize_params(params), 1, None)
    variants["int8 + int8 KV"] = (variants["int8"][0], 1, "int8")
    # SmoothQuant W8A8: smoothing fold + per-token activation int8 on
    # batch-wide GEMMs (ops/linear.w8a8_matmul; NLL evaluates prefill, which
    # is exactly the path act_int8 switches)
    from fastertransformer4codefuse_tpu.ckpt.smoothquant import (
        apply_smoothquant_scaling,
    )

    print("collecting SmoothQuant activation stats...", flush=True)
    sq_stats = collect_activation_stats(cfg, params, calib)
    sq = apply_smoothquant_scaling(cfg, params, sq_stats)
    variants["int8 W8A8 (SmoothQuant)"] = (quantize_params(sq), 1, None)
    variants["int4 per-channel"] = (
        quantize_params(params, weight_bits=4), 1, None,
    )
    variants["int4 g128"] = (
        quantize_params(params, weight_bits=4, group_size=128), 1, None,
    )
    print("collecting AWQ activation stats...", flush=True)
    stats = collect_activation_stats(cfg, params, calib)
    awq = apply_awq_scaling(cfg, params, stats, weight_bits=4, group_size=128)
    variants["int4 g128 + AWQ"] = (
        quantize_params(awq, weight_bits=4, group_size=128), 1, None,
    )
    variants["int4 g128 + AWQ + int8 KV"] = (variants["int4 g128 + AWQ"][0], 1, "int8")
    variants["int4 g128 + AWQ + int8k4v KV"] = (
        variants["int4 g128 + AWQ"][0], 1, "int8k_int4v",
    )
    variants["int4 g128 + AWQ + int4 KV"] = (variants["int4 g128 + AWQ"][0], 1, "int4")

    prompts = [
        held[i * 64 : i * 64 + 64].tolist() for i in range(args.prompts)
    ]

    def engine(p, mode, kv, a8=False):
        return GptNeoXEngine(
            cfg, p,
            RuntimeConfig(
                dtype="fp32", int8_mode=mode, kv_cache_dtype=kv, seq_bucket=64,
                act_int8=a8,
            ),
        )

    eng_fp = engine(*variants["fp32"])
    # decode-path NLL baseline: fp32 weights through a bf16 cache — prefill
    # NLL cannot see the KV dtype, so KV rows get this extra column
    from quality_eval import eval_decode_nll

    dec_ids = nll_ids[: min(len(nll_ids), 4096)]
    import jax.numpy as jnp

    dec_fp = eval_decode_nll(cfg, params, dec_ids, jnp.bfloat16)
    print(f"decode-path fp32/bf16KV NLL baseline: {dec_fp:.4f}", flush=True)

    from fastertransformer4codefuse_tpu.ops import routes

    rows = []
    nll_fp = None
    for name, (p, mode, kv) in variants.items():
        a8 = "W8A8" in name
        with routes.use(routes.Routes(act_int8=a8)):
            nll = eval_nll(cfg, p, nll_ids)
            if nll_fp is None:
                nll_fp = nll
                agree = 1.0
            else:
                agree = greedy_agreement(
                    eng_fp, engine(p, mode, kv, a8), prompts,
                    output_len=args.gen_len,
                )
        dec_d = None
        if kv is not None:
            kv_dt = jnp.int8 if kv == "int8" else kv
            dec_d = eval_decode_nll(cfg, p, dec_ids, kv_dt) - dec_fp
        rows.append((name, nll, np.exp(nll), nll - nll_fp, agree, dec_d))
        dec_s = f"  decode-dNLL {dec_d:+.4f}" if dec_d is not None else ""
        print(
            f"{name:32s} nll {nll:.4f}  ppl {np.exp(nll):7.3f}  "
            f"dNLL {nll - nll_fp:+.4f}  greedy-agree {agree*100:5.1f}%{dec_s}",
            flush=True,
        )

    if args.out:
        lines = [
            "| config | NLL | ppl | dNLL vs fp32 | greedy agreement | decode dNLL (KV) |",
            "|---|---|---|---|---|---|",
        ]
        for name, nll, ppl, d, agree, dec_d in rows:
            dc = f"{dec_d:+.4f}" if dec_d is not None else "—"
            lines.append(
                f"| {name} | {nll:.4f} | {ppl:.3f} | {d:+.4f} | "
                f"{agree*100:.1f}% | {dc} |"
            )
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
        print(f"appended table to {args.out}")


if __name__ == "__main__":
    main()
