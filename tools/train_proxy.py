"""Train a small byte-level GPT-NeoX on this repo's own source text.

Purpose: a QUALITY-EVAL PROXY with *trained* weight statistics. This
environment has no downloadable checkpoints (zero egress), and random
Gaussian weights are a dishonest quantization testbed — trained weights
develop the per-channel outliers that group-wise scaling and AWQ exist for.
Training the framework's own model (models/gptneox.prefill is a pure,
differentiable jax program) on real text yields weights whose int8/int4
NLL deltas behave like a real LM's.

The reference has no analog (it ships no trainer); this exists purely to
put numbers behind the quantization-quality claims (see QUALITY.md).

  python tools/train_proxy.py --steps 600 --out chiprun_out/ftcf_proxy.npz
"""
import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def load_corpus(root: str, extra_roots=()) -> np.ndarray:
    """Byte stream of source text: the repo's Python + Markdown, plus any
    ``extra_roots`` (e.g. the read-only reference checkout's C++/CUDA — tens
    of MB of real code text, which a larger proxy needs to not overfit)."""
    exts = ("*.py", "*.md")
    extra_exts = ("*.py", "*.md", "*.cc", "*.cu", "*.h", "*.hpp", "*.cpp")
    paths = sorted(
        sum((glob.glob(os.path.join(root, "**", e), recursive=True) for e in exts), [])
        + sum(
            (glob.glob(os.path.join(r, "**", e), recursive=True)
             for r in extra_roots for e in extra_exts),
            [],
        )
    )
    blobs = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
        except OSError:
            pass
    data = b"\n\n".join(blobs)
    return np.frombuffer(data, dtype=np.uint8).astype(np.int32)


def proxy_config():
    from fastertransformer4codefuse_tpu import GptNeoXConfig

    # default ~19M params: big enough for real channel statistics, small
    # enough to train on CPU in minutes. vocab 256 = raw bytes. Architecture
    # knobs match CodeFuse (gptj residual, tanh-gelu, rotary pct 0.5).
    return GptNeoXConfig.tiny(
        head_num=8,
        size_per_head=64,
        layer_num=6,
        vocab_size=256,
        rotary_embedding_dim=32,
        inter_size=2048,
        activation="gelu-tanh",
        model_name="proxy19m",
    )


def sized_config(heads, dh, layers, inter):
    from fastertransformer4codefuse_tpu import GptNeoXConfig

    return GptNeoXConfig.tiny(
        head_num=heads,
        size_per_head=dh,
        layer_num=layers,
        vocab_size=256,
        rotary_embedding_dim=dh // 2,
        inter_size=inter,
        activation="gelu-tanh",
        model_name=f"proxy-h{heads}x{dh}-L{layers}",
    )


def config_of_ckpt(path):
    """Rebuild the proxy config a checkpoint was trained with (stored as
    __config__ json in the npz; default-19M for older checkpoints)."""
    import json

    z = np.load(path, allow_pickle=False)
    if "__config__" in z.files:
        kw = json.loads(str(z["__config__"]))
        return sized_config(**kw)
    return proxy_config()


def save_params(path: str, params) -> None:
    import jax

    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = {}
    for kp, leaf in flat:
        key = "/".join(str(k.key) for k in kp)
        out[key] = np.asarray(leaf)
    np.savez(path, **out)


def load_params(path: str):
    """Rebuild the nested params dict from an npz written by save_params."""
    import jax.numpy as jnp

    z = np.load(path)
    params = {}
    for key in z.files:
        if key.startswith("__"):  # metadata (e.g. __config__), not a leaf
            continue
        parts = key.split("/")
        d = params
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(z[key])
    return params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="chiprun_out/ftcf_proxy.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--inter", type=int, default=2048)
    ap.add_argument("--corpus-extra", default="",
                    help="comma-separated extra source roots (e.g. the "
                    "reference checkout) to enlarge the byte corpus")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from fastertransformer4codefuse_tpu import init_params
    from fastertransformer4codefuse_tpu.models import gptneox as model

    cfg = sized_config(args.heads, args.dh, args.layers, args.inter)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    corpus = load_corpus(
        root, [r for r in args.corpus_extra.split(",") if r]
    )
    split = int(len(corpus) * 0.95)
    train, held = corpus[:split], corpus[split:]
    print(f"corpus: {len(corpus)} bytes ({split} train / {len(held)} held-out)")

    params = init_params(cfg, rng=jax.random.PRNGKey(args.seed), dtype="fp32")
    n_params = sum(x.size for x in jax.tree.leaves(params))
    print(f"params: {n_params/1e6:.1f}M")

    warmup = min(50, max(args.steps // 10, 1))
    opt = optax.adamw(
        optax.warmup_cosine_decay_schedule(
            0.0, args.lr, warmup, max(args.steps, warmup + 1)
        ),
        weight_decay=0.01,
    )
    opt_state = opt.init(params)
    B, S = args.batch, args.seq

    def loss_fn(p, ids):
        cache = model.init_kv_cache(cfg, B, S, jnp.float32)
        hidden, _ = model.prefill(cfg, p, ids, jnp.full((B,), S, jnp.int32), cache)
        logits = model.lm_logits(cfg, p, hidden)  # [B, S, V]
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        tgt = ids[:, 1:]
        nll = -jnp.take_along_axis(lp, tgt[..., None], axis=-1)
        return nll.mean()

    @jax.jit
    def step(p, o, ids):
        loss, g = jax.value_and_grad(loss_fn)(p, ids)
        updates, o = opt.update(g, o, p)
        return optax.apply_updates(p, updates), o, loss

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.steps):
        starts = rng.integers(0, len(train) - S - 1, size=B)
        ids = jnp.asarray(np.stack([train[s : s + S] for s in starts]))
        params, opt_state, loss = step(params, opt_state, ids)
        if i % 50 == 0 or i == args.steps - 1:
            print(
                f"step {i:5d}  loss {float(loss):.4f}  "
                f"({(time.time()-t0):.0f}s)",
                flush=True,
            )

    save_params(args.out, params)
    # append the config so evaluators rebuild the right architecture
    import json
    z = dict(np.load(args.out, allow_pickle=False))
    z["__config__"] = np.array(json.dumps(dict(
        heads=args.heads, dh=args.dh, layers=args.layers, inter=args.inter
    )))
    np.savez(args.out, **z)
    np.save(args.out + ".heldout.npy", held)
    print(f"saved {args.out} (+ .heldout.npy, {len(held)} bytes)")


if __name__ == "__main__":
    main()
