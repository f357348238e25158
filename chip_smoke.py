#!/usr/bin/env python3
"""Run CodeFuse-13B serving end to end on one GPU and check what comes out.

    python chip_smoke.py                 # one card, every phase below
    python chip_smoke.py --compare-xla   # also time the GPU routes against XLA
    python chip_smoke.py --four-cards    # only the tensor-parallel phase

Phases (each prints its own lines; a failed check raises and the script exits
non-zero without the final result line):

1. Device: the JAX devices must be GPUs (there is no CPU fallback). The card's
   name and power limit (nvidia-smi) prefix every later timing line.
2. One-shot engine at full size (40 layers, hidden 5120, vocab 100831),
   weights from ``--seed``: bf16 weights with a bf16 KV cache, then int8
   weight-only weights with an int8 KV cache. B=1 and B=4, 1024-token
   prompts, 128 greedy tokens; sampled decode with per-row seeds (run twice,
   must agree); streaming ``callback=`` (must equal the non-streaming run).
3. Served path: ``CodeFuseHandler`` over the int8 engine with a paged pool,
   then a dense pool; eight concurrent ``predict()`` requests from threads,
   one streaming. Every greedy answer is checked token by token against the
   model's own forward over prompt + answer (teacher forcing), and compared
   with the one-shot engine's tokens for the same prompts.
4. Kernel parity at real widths: the Triton decode kernel (dense and paged
   cache) and cuDNN prefill attention against the plain float32 jnp paths.
5. Model parity: a 2-layer full-width slice in float32 at "highest" matmul
   precision against its bf16 and int8 runs.
6. ``--four-cards``: CodeFuse-13B int8 under ``build_mesh(tp=4)``, one-shot
   and through a dense pool, against the same runs on one card; every greedy
   answer is teacher-forced through the one-card model.

The last line printed is the JSON result
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Compiled programs are kept in the persistent compile cache
(utils/compile_cache.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np

CARD = "unknown card"

PROMPT_LEN = 1024
OUT_LEN = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def tlog(msg: str) -> None:
    """A timing line: carries the card's name and power limit."""
    print(f"[{CARD}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ------------------------------------------------------------------ phase 1 --
def phase_device(want: int):
    import jax

    global CARD
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r})"
        )
    check(len(devs) >= want, f"need {want} GPUs, JAX sees {len(devs)}")
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    CARD = q.stdout.strip().splitlines()[0]
    log(q.stdout.strip())
    log(f"phase 1 device: {len(devs)} x {devs[0].device_kind} "
        f"(platform {devs[0].platform}); nvidia-smi: {CARD}")
    return devs


# ------------------------------------------------------------------ phase 2 --
def make_prompts(rng, cfg, n: int, length: int):
    """Random token ids below the end id (never an early stop in the prompt)."""
    return rng.integers(0, cfg.end_id, size=(n, length)).tolist()


def generated(out, b: int, in_len: int):
    n = int(out.sequence_lengths[b, 0])
    return [int(t) for t in out.output_ids[b, 0, in_len:n]]


def run_oneshot(label, eng, prompts, out_len=OUT_LEN):
    """Greedy B=1 and B=4 (timed; prefill from a 1-token run), sampled B=4
    twice (determinism), streamed B=1 (equals the non-streamed tokens)."""
    cfg = eng.config
    res = {}
    for B in (1, 4):
        ids = prompts[:B]
        kw = dict(top_k=1, return_cum_log_probs=True)
        _, t_c1 = timed(lambda: eng.generate(ids, output_len=1, **kw))
        _, t_p = timed(lambda: eng.generate(ids, output_len=1, **kw))
        _, t_cn = timed(lambda: eng.generate(ids, output_len=out_len, **kw))
        out, t_n = timed(lambda: eng.generate(ids, output_len=out_len, **kw))
        steps = out_len - 1
        tlog(f"{label} B={B}: compile {t_c1 - t_p:.1f} s + {t_cn - t_n:.1f} s, "
             f"prefill {1e3 * t_p:.1f} ms, decode {1e3 * (t_n - t_p) / steps:.2f} "
             f"ms/step, {B * out_len / t_n:.1f} tok/s end to end")
        for b in range(B):
            g = generated(out, b, len(ids[b]))
            check(len(g) >= 1 and all(0 <= t < cfg.vocab_size for t in g),
                  f"{label} B={B} row {b}: bad tokens")
        # the sum of the chosen tokens' log-probs is finite only if every
        # step's logits were
        check(np.isfinite(out.cum_log_probs).all(),
              f"{label} B={B}: non-finite logits (cum log-probs "
              f"{out.cum_log_probs.ravel().tolist()})")
        res[B] = out
    same = sum(
        a == b for a, b in zip(generated(res[1], 0, PROMPT_LEN),
                               generated(res[4], 0, PROMPT_LEN))
    )
    log(f"{label}: row 0 greedy tokens equal between B=1 and B=4 runs: "
        f"{same}/{out_len} (batch shapes change the reduction order)")

    kw = dict(
        top_k=[50, 40, 1, 8], top_p=[0.9, 0.0, 0.0, 0.5],
        temperature=[0.8, 1.2, 1.0, 0.7],
        repetition_penalty=[1.1, 1.0, 1.3, 1.0],
        random_seed=[11, 22, 33, 44],
    )
    s1, t_s = timed(lambda: eng.generate(prompts[:4], output_len=out_len, **kw))
    s2 = eng.generate(prompts[:4], output_len=out_len, **kw)
    check(np.array_equal(s1.output_ids, s2.output_ids),
          f"{label}: sampled decode is not deterministic under fixed seeds")
    tlog(f"{label} sampled B=4 (top-k/top-p/temperature/repetition penalty, "
         f"per-row seeds): first call {t_s:.1f} s; two runs agree")

    got = []
    out_s, t_st = timed(lambda: eng.generate(
        prompts[:1], output_len=out_len, top_k=1,
        callback=lambda m: got.append(m["last_tokens"][0][0]),
    ))
    want = generated(res[1], 0, PROMPT_LEN)
    check(generated(out_s, 0, PROMPT_LEN) == want,
          f"{label}: streamed run's tokens differ from the non-streamed run")
    check(got[: len(want)] == want,
          f"{label}: callback tokens differ from the non-streamed run")
    tlog(f"{label} streaming B=1: first call {t_st:.1f} s; {len(got)} callbacks, "
         f"tokens equal the non-streamed run")
    return res


def phase_oneshot(cfg, seed, mode: str):
    """``mode`` "bf16": bf16 weights + bf16 KV; "int8": int8 weight-only
    (per-channel scales) + int8 KV. Returns the engine."""
    import jax

    from fastertransformer4codefuse_tpu import (
        GptNeoXEngine, RuntimeConfig, init_params,
    )

    rng = np.random.default_rng(seed)
    prompts = make_prompts(rng, cfg, 4, PROMPT_LEN)
    int8 = mode == "int8"
    label = "2b int8/int8" if int8 else "2a bf16/bf16"
    params, t = timed(lambda: jax.block_until_ready(init_params(
        cfg, rng=jax.random.PRNGKey(seed), dtype="bf16", int8_mode=int(int8))))
    tlog(f"phase {label}: weights from seed {seed} in {t:.1f} s")
    eng = GptNeoXEngine(cfg, params, RuntimeConfig(
        dtype="bf16", int8_mode=int(int8), kv_cache_dtype=mode, seq_bucket=128))
    run_oneshot(label, eng, prompts)
    return eng


# ------------------------------------------------------------------ phase 3 --
class ByteTokenizer:
    """Byte-level stand-in tokenizer: a prompt's bytes are its token ids, and
    decode writes each id as ``<id>`` so every id of the model's vocabulary
    round-trips through the handler's text response."""

    def encode(self, text):
        return list(text.encode("latin-1"))

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)

    def get_vocab(self):
        return {chr(i): i for i in range(256)}


def ids_of(text: str):
    return [int(x) for x in re.findall(r"<(\d+)>", text)]


def served_prompts(rng, n=8):
    """Byte prompts of assorted lengths (printable ASCII)."""
    lens = [1024, 896, 767, 640, 513, 384, 255, 128][:n]
    return ["".join(chr(c) for c in rng.integers(32, 127, size=L)) for L in lens]


def teacher_forced_gaps(eng, prompts_ids, answers):
    """Run the model over prompt + answer in one prefill and return, per
    request, the gap max_logit - logit(answer token) at every answer position
    (0 where the answer is the model's own argmax), and the logit std."""
    import jax
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu.models import gptneox as model

    cfg = eng.config
    seqs = [p + a for p, a in zip(prompts_ids, answers)]
    S = -(-max(len(s) for s in seqs) // 128) * 128
    A = max(len(a) for a in answers)
    toks = np.full((len(seqs), S), cfg.end_id, np.int32)
    for i, s in enumerate(seqs):
        toks[i, : len(s)] = s
    lens = np.array([len(s) for s in seqs], np.int32)
    # logits at positions len(prompt)-1 ... len(prompt)+len(answer)-2
    pos = np.zeros((len(seqs), A), np.int32)
    for i, (p, a) in enumerate(zip(prompts_ids, answers)):
        pos[i, : len(a)] = len(p) - 1 + np.arange(len(a))

    @eng.jit  # traced under the engine's routes
    def logits_at(params, toks, lens, pos):
        cache = model.init_kv_cache(cfg, toks.shape[0], toks.shape[1], eng._cache_dtype())
        h, _ = model.prefill(cfg, params, toks, lens, cache)
        h = jnp.take_along_axis(h, pos[:, :, None], axis=1)
        return model.lm_logits(cfg, params, h)

    lg = np.asarray(logits_at(eng.params, jnp.asarray(toks), jnp.asarray(lens),
                              jnp.asarray(pos)))
    gaps = []
    for i, a in enumerate(answers):
        row = lg[i, : len(a)]
        gaps.append(row.max(-1) - row[np.arange(len(a)), a])
    return gaps, float(lg.std())


def phase_served(eng, seed, paged: bool, reference=None):
    import jax

    from fastertransformer4codefuse_tpu.api.handler import CodeFuseHandler

    label = "3 paged pool" if paged else "3 dense pool"
    pool = dict(max_slots=8, max_seq_len=2048, prompt_bucket=128)
    if paged:
        pool["paged"] = dict(num_pages=8 * 2048 // 256 + 1, page_size=256)
    tok = ByteTokenizer()
    streamed = []
    handler = CodeFuseHandler(
        engine=eng, tokenizer=tok, warmup=False, pool=pool,
        on_stream_text=lambda b, j, s: streamed.append(s),
    )
    rng = np.random.default_rng(seed + 1)
    texts = served_prompts(rng)
    out_len = 64
    results = [None] * len(texts)

    def ask(i):
        req = {"prompts": [{"prompt": texts[i], "top_k": 1, "random_seed": i}],
               "out_seq_length": out_len, "stream": i == 3}
        results[i] = handler.predict(req, f"smoke-{i}")

    try:
        # one warm request compiles the pool's programs
        _, t_warm = timed(lambda: handler.predict(
            {"prompts": [{"prompt": texts[-1], "top_k": 1}], "out_seq_length": 4},
            "warm"))
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(texts))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
    finally:
        handler.server.close()
    answers = []
    for i, r in enumerate(results):
        check(r is not None and r[0] == 0, f"{label}: request {i} failed: {r}")
        res = json.loads(r[2]["res"])
        answers.append(ids_of(res["generated_code"][0][0]))
        check(len(answers[-1]) == res["length"][0][0],
              f"{label}: request {i} response length mismatch")
    n_tok = sum(len(a) for a in answers)
    tlog(f"{label}: warm-up (compile) {t_warm:.1f} s; {len(texts)} concurrent "
         f"requests, {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s")
    check(ids_of("".join(streamed)) == answers[3],
          f"{label}: streamed text differs from the streaming request's answer")
    log(f"{label}: streamed chunks of request 3 equal its answer")

    prompts_ids = [tok.encode(t) for t in texts]
    gaps, lstd = teacher_forced_gaps(eng, prompts_ids, answers)
    worst = max(float(g.max()) for g in gaps)
    exact = sum(int((g == 0).sum()) for g in gaps)
    # a greedy token is the argmax of the pool's own logits; the teacher-forced
    # forward reorders the reductions (one prefill instead of chunks + steps,
    # bf16 attention over the unquantized prompt K/V), so near-ties may
    # flip. Tolerance: the chosen token's logit within 0.15 logit std of max.
    tol = 0.15 * lstd
    log(f"{label}: teacher-forced check: {exact}/{n_tok} answer tokens are the "
        f"forward's argmax; worst gap {worst:.4f} (tolerance {tol:.4f} = 0.15 "
        f"x logit std {lstd:.3f})")
    check(worst <= tol, f"{label}: an answer token is not the model's greedy choice")
    if reference is not None:
        agree = []
        for a, r in zip(answers, reference):
            n = 0
            while n < min(len(a), len(r)) and a[n] == r[n]:
                n += 1
            agree.append(n)
        log(f"{label}: tokens equal to the one-shot engine's before the first "
            f"difference, per request: {agree} of {[len(a) for a in answers]}")
    return answers, prompts_ids


def oneshot_reference(eng, prompts_ids, out_len=64):
    """The one-shot engine's greedy tokens for the served prompts (one
    ragged batch: packed rows keep per-row positions exact)."""
    out = eng.generate(prompts_ids, output_len=out_len, top_k=1)
    answers = [generated(out, b, len(p)) for b, p in enumerate(prompts_ids)]
    gaps, lstd = teacher_forced_gaps(eng, prompts_ids, answers)
    worst = max(float(g.max()) for g in gaps)
    log(f"3 one-shot reference (B=8 ragged): worst teacher-forced gap "
        f"{worst:.4f} (tolerance {0.15 * lstd:.4f})")
    check(worst <= 0.15 * lstd, "one-shot answer is not the model's greedy choice")
    return answers


# ------------------------------------------------------------------ phase 4 --
def bench_us(fn, *args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return 1e6 * (time.perf_counter() - t0) / reps


def phase_kernels(interpret=False, nH=40, dh=128, seqs=(1024, 2048), batches=(1, 8),
                  timing=True):
    """Each GPU route against the plain jnp path in float32 ("highest")."""
    import jax
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu.engine import kv_cache as kvc
    from fastertransformer4codefuse_tpu.engine import paged_kv
    from fastertransformer4codefuse_tpu.ops import attention as att
    from fastertransformer4codefuse_tpu.ops.flash_decode import (
        flash_decode_paged, flash_decode_stacked,
    )

    rng = np.random.default_rng(0)
    sm = 1.0 / float(np.sqrt(dh))
    # the kernel sums in float32 over the same cache values as the reference;
    # its output is rounded to bf16 (8 significant bits): 1e-2 x max|ref|
    tol_rel = 1e-2
    log(f"phase 4 kernel parity: tolerance max|out - ref| <= {tol_rel} x "
        f"max(1, max|ref|) (bf16 output rounding; float32 sums in both)")

    def ref_attend(cache, q, pos):
        S = kvc.seq_len_of(cache)
        valid = jnp.arange(S)[None, :] <= pos[:, None]
        f32 = {k: (v if v.dtype == jnp.int8 else v.astype(jnp.float32))
               for k, v in cache.items()}
        with jax.default_matmul_precision("highest"):
            return jax.jit(lambda c, q, p, v: kvc.attend_decode(
                c, jnp.int32(1), q, v, sm, positions=p))(
                    f32, q.astype(jnp.float32), pos, valid)

    def compare(name, out, ref, t_k=None, t_x=None):
        out = np.asarray(out, np.float32)
        ref = np.asarray(ref, np.float32)
        err = float(np.abs(out - ref).max())
        bound = tol_rel * max(1.0, float(np.abs(ref).max()))
        times = ""
        if t_k is not None:
            times = f"; kernel {t_k:.1f} us, XLA {t_x:.1f} us"
        (tlog if t_k is not None else log)(
            f"  {name}: max err {err:.2e} (bound {bound:.2e}){times}")
        check(np.isfinite(out).all() and err <= bound, f"{name}: parity failed")

    L = 2
    for S in seqs:
        for B in batches:
            pos = jnp.asarray([S - 1 - 97 * b for b in range(B)], jnp.int32)
            q = jnp.asarray(rng.standard_normal((B, nH, dh)), jnp.bfloat16)
            for kind in ("bf16", "int8"):
                cache = kvc.init_cache(
                    _Cfg(L, nH, dh), B, S,
                    jnp.int8 if kind == "int8" else jnp.bfloat16)
                cache = _fill(cache, rng)
                k_fn = jax.jit(lambda c, q, p: flash_decode_stacked(
                    q, c["k"], c.get("k_s"), c["v"], c.get("v_s"), jnp.int32(1),
                    p, sm_scale=sm, interpret=interpret))
                out = k_fn(cache, q, pos)
                ref = ref_attend(cache, q, pos)
                t_k = t_x = None
                if timing:
                    valid = jnp.arange(S)[None, :] <= pos[:, None]
                    x_fn = jax.jit(lambda c, q, p, v: kvc.attend_decode(
                        c, jnp.int32(1), q, v, sm, positions=p))
                    t_k = bench_us(k_fn, cache, q, pos)
                    t_x = bench_us(x_fn, cache, q, pos, valid)
                compare(f"decode dense {kind} B={B} S={S}", out, ref, t_k, t_x)
                if S == max(seqs):
                    pg = _paged_from_dense(cache, paged_kv, page_size=256)
                    kp_fn = jax.jit(lambda c, q, p: flash_decode_paged(
                        q, c["pk"], c.get("pk_s"), c["pv"], c.get("pv_s"),
                        jnp.int32(1), p, c["pt"], sm_scale=sm,
                        interpret=interpret))
                    out = kp_fn(pg, q, pos)
                    t_k = t_x = None
                    if timing:
                        valid = jnp.arange(S)[None, :] <= pos[:, None]
                        xp_fn = jax.jit(lambda c, q, p, v: kvc.attend_decode(
                            c, jnp.int32(1), q, v, sm, positions=p))
                        t_k = bench_us(kp_fn, pg, q, pos)
                        t_x = bench_us(xp_fn, pg, q, pos, valid)
                    compare(f"decode paged {kind} B={B} S={S}", out, ref, t_k, t_x)
    if interpret:
        return
    # a paged int8 pool at the served size (40 layers, 65 pages of 256: 3.4 GB
    # per slab) read at its last layer: offsets past 2**31 bytes
    import jax.random as jr

    B, S, ps, L = 8, 2048, 256, 40
    P = B * S // ps + 1
    keys = jr.split(jr.PRNGKey(3), 4)
    shape = (L, P, nH, ps, dh)
    pool = {
        "pk": jr.randint(keys[0], shape, -127, 128, jnp.int8),
        "pv": jr.randint(keys[1], shape, -127, 128, jnp.int8),
        "pk_s": (jr.uniform(keys[2], shape[:4]) * 0.02).astype(jnp.bfloat16),
        "pv_s": (jr.uniform(keys[3], shape[:4]) * 0.02).astype(jnp.bfloat16),
        "pt": jnp.asarray(np.random.default_rng(2).permutation(np.arange(1, P))
                          .reshape(B, S // ps), jnp.int32),
    }
    pos = jnp.asarray([S - 1 - 97 * b for b in range(B)], jnp.int32)
    q = jnp.asarray(rng.standard_normal((B, nH, dh)), jnp.bfloat16)
    out = jax.jit(lambda c, q, p: flash_decode_paged(
        q, c["pk"], c["pk_s"], c["pv"], c["pv_s"], jnp.int32(L - 1), p, c["pt"],
        sm_scale=sm))(pool, q, pos)
    valid = jnp.arange(S)[None, :] <= pos[:, None]
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda c, q, p, v: kvc.attend_decode(
            c, jnp.int32(L - 1), q, v, sm, positions=p))(
                pool, q.astype(jnp.float32), pos, valid)
    compare(f"decode paged int8 B={B} S={S}, {L} layers x {P} pages, last layer",
            out, ref)
    del pool
    # the int8 GEMV on stacked 13B weights (qkv: 3.1 GB, up: 4.2 GB) at the
    # last layer, decode widths, against XLA's GEMM on the same layer
    from fastertransformer4codefuse_tpu.ops import linear as lin
    from fastertransformer4codefuse_tpu.ops.int8_gemv import int8_gemv_stacked
    from fastertransformer4codefuse_tpu.models.params import QuantizedTensor

    log("  int8 GEMV: tolerance 1e-2 x max(1, max|ref|) (bf16 products, float32 sums)")
    for name, K, N in (("qkv", 5120, 15360), ("up", 5120, 20480), ("down", 20480, 5120)):
        kq, ks = jr.split(jr.PRNGKey(K + N))
        qw = jr.randint(kq, (40, K, N), -127, 128, jnp.int8)
        sc = (jr.uniform(ks, (40, N)) * 1e-3).astype(jnp.float32)
        for M in (1, 4):
            x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
            g_fn = jax.jit(lambda x, q, s: int8_gemv_stacked(x, q, s, jnp.int32(39)))
            out = g_fn(x, qw, sc)
            with jax.default_matmul_precision("highest"):
                ref = jax.jit(lambda x, q, s: lin.quantized_matmul_xla(
                    x.astype(jnp.float32),
                    QuantizedTensor(q=q[39], scale=s[39], k_axis=-2)))(x, qw, sc)
            x_fn = jax.jit(lambda x, q, s: lin.quantized_matmul_xla(
                x, QuantizedTensor(q=q[39], scale=s[39], k_axis=-2)))
            compare(f"int8 GEMV {name} M={M} K={K} N={N}, layer 39 of 40", out, ref,
                    bench_us(g_fn, x, qw, sc), bench_us(x_fn, x, qw, sc))
        del qw
    # prefill attention: cuDNN's fused kernel vs the einsum path
    for S in seqs:
        B = 1
        lens = jnp.asarray([S - 100], jnp.int32)
        q, k, v = (jnp.asarray(rng.standard_normal((B, S, nH, dh)), jnp.bfloat16)
                   for _ in range(3))
        f_fn = jax.jit(lambda q, k, v, n: att.prefill_attention_fused(q, k, v, n, sm))
        out = f_fn(q, k, v, lens)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda q, k, v, n: att.prefill_attention(
                q, k, v, att.make_prefill_mask(n, S), sm))(
                    *(x.astype(jnp.float32) for x in (q, k, v)), lens)
        x_fn = jax.jit(lambda q, k, v, n: att.prefill_attention(
            q, k, v, att.make_prefill_mask(n, S), sm))
        live = int(lens[0])
        # cuDNN keeps P in bf16 for the PV product: 2e-2 x max|ref|
        out_l = np.asarray(out, np.float32)[:, :live]
        ref_l = np.asarray(ref, np.float32)[:, :live]
        err = float(np.abs(out_l - ref_l).max())
        bound = 2e-2 * max(1.0, float(np.abs(ref_l).max()))
        tlog(f"  prefill cuDNN B={B} S={S}: max err {err:.2e} (bound {bound:.2e}, "
             f"bf16 probabilities); cuDNN {bench_us(f_fn, q, k, v, lens, reps=5):.1f}"
             f" us, einsum {bench_us(x_fn, q, k, v, lens, reps=5):.1f} us")
        check(np.isfinite(out_l).all() and err <= bound, "prefill cuDNN parity failed")


@dataclasses.dataclass
class _Cfg:
    """The cache shape fields of a model config."""
    layer_num: int
    head_num: int
    size_per_head: int

    @property
    def kv_heads(self):
        return self.head_num


def _fill(cache, rng):
    import jax.numpy as jnp

    out = {}
    for k, v in cache.items():
        if v.dtype == jnp.int8:
            out[k] = jnp.asarray(rng.integers(-127, 128, v.shape), jnp.int8)
        elif k.endswith("_s"):
            out[k] = jnp.asarray(rng.random(v.shape) * 0.02, v.dtype)
        else:
            out[k] = jnp.asarray(rng.standard_normal(v.shape), v.dtype)
    return out


def _paged_from_dense(cache, paged_kv, page_size):
    """The same cache contents in a paged pool with a scrambled block table."""
    import jax.numpy as jnp

    L, B, nH, S = cache["k"].shape[:4]
    n_pg = S // page_size
    P = B * n_pg + 1
    perm = np.random.default_rng(1).permutation(np.arange(1, P))
    pt = perm.reshape(B, n_pg)
    out = {"pt": jnp.asarray(pt, jnp.int32)}
    for name in [n for n in ("k", "v", "k_s", "v_s") if n in cache]:
        x = np.asarray(cache[name])
        pages = np.zeros((L, P, nH, page_size) + x.shape[4:], x.dtype)
        for b in range(B):
            for j in range(n_pg):
                pages[:, pt[b, j]] = x[:, b, :, j * page_size:(j + 1) * page_size]
        out["p" + name] = jnp.asarray(pages)
    return out


# ------------------------------------------------------------------ phase 5 --
def phase_model_parity(cfg, seed, layers=2, B=4, S=128):
    """2-layer full-width slice: float32 ("highest") vs bf16 and int8."""
    import jax
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu import GptNeoXEngine, RuntimeConfig
    from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params
    from fastertransformer4codefuse_tpu.models import gptneox as model
    from fastertransformer4codefuse_tpu.models.params import cast_params, init_params

    cfg2 = dataclasses.replace(cfg, layer_num=layers)
    p32 = init_params(cfg2, rng=jax.random.PRNGKey(seed), dtype="fp32")
    rng = np.random.default_rng(seed + 2)
    toks = jnp.asarray(rng.integers(0, cfg.end_id, size=(B, S)), jnp.int32)
    lens = jnp.asarray([S - 7 * b for b in range(B)], jnp.int32)

    def logits(params, kv):
        # traced under the engine's routes (cuDNN prefill for 16-bit operands)
        eng = GptNeoXEngine(cfg2, params, RuntimeConfig(dtype="bf16"))

        @eng.jit
        def f(params, toks, lens):
            cache = model.init_kv_cache(cfg2, B, S, kv)
            h, _ = model.prefill(cfg2, params, toks, lens, cache)
            return model.lm_logits(cfg2, params, h)
        return np.asarray(f(params, toks, lens), np.float32)

    with jax.default_matmul_precision("highest"):
        ref = logits(p32, jnp.float32)
    live = np.arange(S)[None, :] < np.asarray(lens)[:, None]
    ref_l = ref[live]
    lstd = float(ref_l.std())
    # tolerances on the RMS logit error relative to the logit std, and on
    # argmax agreement over every live position: bf16 weights and activations
    # keep ~3 significant digits -> 0.02 and 90%; int8 per-channel weights
    # and KV add ~0.5% error per value -> 0.05 and 80%
    for name, params, kv, tol, agree_min in (
        ("bf16", cast_params(p32, "bf16"), jnp.bfloat16, 0.02, 0.90),
        ("int8", quantize_params(cast_params(p32, "bf16")), jnp.int8, 0.05, 0.80),
    ):
        got = logits(params, kv)[live]
        rms = float(np.sqrt(np.mean((got - ref_l) ** 2))) / lstd
        worst = float(np.abs(got - ref_l).max()) / lstd
        agree = float((got.argmax(-1) == ref_l.argmax(-1)).mean())
        log(f"phase 5 model parity {name} ({layers}-layer 13B slice, {int(live.sum())} "
            f"positions): rms logit err/std {rms:.4f} (tol {tol}), max {worst:.4f}; "
            f"greedy agreement {agree:.3f} (min {agree_min})")
        check(rms <= tol and agree >= agree_min, f"model parity {name} failed")


# ------------------------------------------------------------------ phase 6 --
def phase_four_cards(cfg, seed, dtype="bf16"):
    import jax
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu import GptNeoXEngine, RuntimeConfig, init_params
    from fastertransformer4codefuse_tpu.engine.server import BatchingServer
    from fastertransformer4codefuse_tpu.models import gptneox as model
    from fastertransformer4codefuse_tpu.parallel.sharding import build_mesh

    rng = np.random.default_rng(seed)
    prompts = make_prompts(rng, cfg, 4, PROMPT_LEN)
    out_len = 32
    rt = RuntimeConfig(dtype=dtype, int8_mode=1, kv_cache_dtype="int8", seq_bucket=128)
    params = jax.block_until_ready(init_params(
        cfg, rng=jax.random.PRNGKey(seed), dtype=dtype, int8_mode=1))
    toks = jnp.asarray(prompts, jnp.int32)
    lens = jnp.full((4,), PROMPT_LEN, jnp.int32)

    def first_logits(eng):
        @eng.jit
        def f(params, toks, lens):
            cache = model.init_kv_cache(cfg, 4, PROMPT_LEN, jnp.int8)
            h, _ = model.prefill(cfg, params, toks, lens, cache)
            return model.lm_logits(cfg, params, model.last_token_hidden(h, lens))
        return np.asarray(f(eng.params, toks, lens), np.float32)

    res, engines = {}, {}
    for tp in (1, 4):
        mesh = build_mesh(tp=tp) if tp > 1 else None
        eng = GptNeoXEngine(cfg, params, rt, mesh=mesh)
        lg = first_logits(eng)
        _, t_c = timed(lambda: eng.generate(prompts, output_len=out_len, top_k=1))
        out, t = timed(lambda: eng.generate(prompts, output_len=out_len, top_k=1))
        tlog(f"phase 6 TP={tp} one-shot B=4 {PROMPT_LEN}+{out_len}: first call "
             f"{t_c:.1f} s, then {t:.2f} s ({4 * out_len / t:.1f} tok/s)")
        srv = BatchingServer(eng, max_slots=4, max_seq_len=2048, prompt_bucket=128)
        try:
            srv.generate(prompts[0][:128], 4)  # compile the pool programs
            uids = [srv.submit(p, out_len, top_k=1) for p in prompts]
            pooled, t_p = timed(lambda: [srv.wait(u) for u in uids])
        finally:
            srv.close()
        tlog(f"phase 6 TP={tp} dense pool 4 requests x {out_len} tokens: {t_p:.2f} s "
             f"({4 * out_len / t_p:.1f} tok/s)")
        res[tp] = (lg, [generated(out, b, PROMPT_LEN) for b in range(4)],
                   [list(r.output_ids[PROMPT_LEN:]) for r in pooled])
        engines[tp] = eng
    lg1, one1, pool1 = res[1]
    lg4, one4, pool4 = res[4]
    std = float(lg1.std())
    rms = float(np.sqrt(np.mean((lg4 - lg1) ** 2))) / std
    worst = float(np.abs(lg4 - lg1).max()) / std
    first = sum(a[0] == b[0] for a, b in zip(one1, one4))
    log(f"phase 6 TP=4 vs 1 card, first-step logits: rms err/std {rms:.4f} "
        f"(tol 0.05), max {worst:.4f}; first token equal {first}/4; one-shot "
        f"sequences equal {sum(a == b for a, b in zip(one1, one4))}/4 (bf16 sums "
        f"in another order over 40 layers)")
    # every greedy answer, teacher-forced through the one-card model: each
    # token within 0.15 logit std of that model's argmax
    for name, answers in (("TP=1 pooled", pool1), ("TP=4 one-shot", one4),
                          ("TP=4 pooled", pool4)):
        gaps, lstd = teacher_forced_gaps(engines[1], prompts, answers)
        gmax = max(float(g.max()) for g in gaps)
        exact = sum(int((g == 0).sum()) for g in gaps)
        log(f"phase 6 {name} answers under the 1-card forward: {exact}/"
            f"{sum(len(a) for a in answers)} the argmax, worst gap {gmax:.4f} "
            f"(tolerance {0.15 * lstd:.4f})")
        check(gmax <= 0.15 * lstd, f"{name} answers are not the model's greedy choice")
    check(rms <= 0.05, "TP=4 first-step logits differ from one card")


# --------------------------------------------------------------------- main --
def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the tensor-parallel phase on 4 GPUs")
    ap.add_argument("--compare-xla", action="store_true",
                    help="also time the engine with the GPU routes off")
    ap.add_argument("--trace", default="",
                    help="write a profiler trace of int8 decode to this directory")
    ap.add_argument("--only", default="",
                    help="comma list of phases to run (kernels, parity, bf16, "
                         "int8, served); default all")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    want = lambda name: not only or name in only

    from fastertransformer4codefuse_tpu import GptNeoXConfig
    from fastertransformer4codefuse_tpu.utils import compile_cache

    import jax

    devs = phase_device(4 if args.four_cards else 1)
    log(f"compile cache: {compile_cache.enable()}")
    cfg = GptNeoXConfig.codefuse_13b()
    if args.four_cards:
        phase_four_cards(cfg, args.seed)
    else:
        if want("kernels"):
            phase_kernels()
        if want("parity"):
            phase_model_parity(cfg, args.seed)
        if want("bf16"):
            phase_oneshot(cfg, args.seed, "bf16")
        if want("int8") or want("served"):
            eng = phase_oneshot(cfg, args.seed, "int8")
            if args.trace:
                trace_decode(eng, args.trace)
            if want("served"):
                rng = np.random.default_rng(args.seed + 1)
                prompts_ids = [ByteTokenizer().encode(t) for t in served_prompts(rng)]
                ref = oneshot_reference(eng, prompts_ids)
                phase_served(eng, args.seed, paged=True, reference=ref)
                phase_served(eng, args.seed, paged=False, reference=ref)
            if args.compare_xla:
                compare_xla(cfg, eng, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)


def trace_decode(eng, trace_dir):
    """Profile int8 B=4 generation and print the top device ops."""
    import jax

    from fastertransformer4codefuse_tpu.utils.profiling import summarize_trace

    rng = np.random.default_rng(5)
    ids = make_prompts(rng, eng.config, 4, PROMPT_LEN)
    eng.generate(ids, output_len=16, top_k=1)
    with jax.profiler.trace(trace_dir):
        eng.generate(ids, output_len=16, top_k=1)
    for line in ("XLA Ops", "Stream"):
        log(f"trace top ops ({line}), int8 B=4 1024+16:")
        for name, ms, n, where in summarize_trace(trace_dir, top=25, line=line):
            tlog(f"  {ms:9.3f} ms {n:6d}x  {name[:90]}  [{where}]")


def compare_xla(cfg, eng, seed):
    """The int8 engine with each GPU route off and on, end to end, in turns:
    one-shot decode with XLA's GEMMs or the int8 GEMV, and with XLA's
    attention or the decode kernel; then the paged pool with the decode
    kernel off and on. Each engine's routes are set before its first trace."""
    from fastertransformer4codefuse_tpu import GptNeoXEngine, RuntimeConfig

    rng = np.random.default_rng(seed)
    prompts = make_prompts(rng, cfg, 4, PROMPT_LEN)
    rt = RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8", seq_bucket=128)
    configs = (("XLA GEMM, XLA attention", False, False),
               ("int8 GEMV, XLA attention", True, False),
               ("int8 GEMV, decode kernel", True, True),
               ("XLA GEMM, XLA attention", False, False))
    for label, gemv, kernel in configs:
        e = GptNeoXEngine(cfg, eng.params, rt)
        e.routes = dataclasses.replace(e.routes, int8_gemv=gemv, flash_decode=kernel)
        for B in (1, 4):
            ids = prompts[:B]
            e.generate(ids, output_len=1, top_k=1)  # the first calls compile
            e.generate(ids, output_len=OUT_LEN, top_k=1)
            _, t_p = timed(lambda: e.generate(ids, output_len=1, top_k=1))
            _, t_n = timed(lambda: e.generate(ids, output_len=OUT_LEN, top_k=1))
            tlog(f"compare one-shot int8/int8 {label} B={B}: prefill "
                 f"{1e3 * t_p:.1f} ms, decode {1e3 * (t_n - t_p) / (OUT_LEN - 1):.3f} "
                 f"ms/step")
    for fd in (False, True):
        e = GptNeoXEngine(cfg, eng.params, rt)
        e.routes = dataclasses.replace(e.routes, flash_decode=fd)
        log(f"compare: paged pool, decode kernel={fd}")
        phase_served(e, seed, paged=True)


if __name__ == "__main__":
    main()
