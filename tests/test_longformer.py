"""Longformer family parity vs HuggingFace (VERDICT r4 item 5): the first
family with a genuinely new attention pattern — per-layer sliding windows +
global tokens — exercising the kernel seam beyond causal/bidirectional.

Reference: /root/reference/src/fastertransformer/models/longformer/ +
kernels/longformer_kernels.cu (sliding-chunk local/global attention).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models.longformer import (
    config_from_hf_longformer,
    encode,
    params_from_hf_longformer_state_dict,
)


def make_hf(seed=0, window=8, layers=2):
    torch.manual_seed(seed)
    cfg = transformers.LongformerConfig(
        vocab_size=96,
        hidden_size=32,
        num_hidden_layers=layers,
        num_attention_heads=4,
        intermediate_size=64,
        max_position_embeddings=64,
        attention_window=window,
        pad_token_id=1,
        type_vocab_size=1,
    )
    return transformers.LongformerModel(cfg).eval()


def run_both(hf, ids, lens, global_rows=()):
    cfg = config_from_hf_longformer(hf.config)
    params = params_from_hf_longformer_state_dict(cfg, hf.state_dict())
    B, S = ids.shape
    am = np.zeros((B, S), np.int64)
    for b in range(B):
        am[b, : lens[b]] = 1
    gm = np.zeros((B, S), np.int64)
    for b, r in global_rows:
        gm[b, r] = 1
    with torch.no_grad():
        out = hf(
            input_ids=torch.tensor(ids, dtype=torch.long),
            attention_mask=torch.tensor(am),
            global_attention_mask=torch.tensor(gm) if gm.any() else None,
        )
    want_h = out.last_hidden_state.numpy()
    want_p = out.pooler_output.numpy()
    got_h, got_p = encode(
        cfg, params, jnp.asarray(ids), jnp.asarray(lens),
        global_mask=jnp.asarray(gm.astype(bool)) if gm.any() else None,
    )
    return np.asarray(got_h), np.asarray(got_p), want_h, want_p


def _assert_close(got_h, got_p, want_h, want_p, lens):
    for b in range(got_h.shape[0]):
        np.testing.assert_allclose(
            got_h[b, : lens[b]], want_h[b, : lens[b]], rtol=2e-4, atol=2e-5
        )
    np.testing.assert_allclose(got_p, want_p, rtol=2e-4, atol=2e-5)


def test_longformer_local_only_parity():
    """Pure sliding-window attention (no global tokens), ragged lengths that
    are NOT window multiples — HF pads internally, the dense band must match
    on every real position."""
    hf = make_hf(seed=0, window=8)
    rng = np.random.RandomState(1)
    ids = rng.randint(2, 96, size=(2, 21)).astype(np.int64)
    lens = np.array([21, 13], np.int32)
    got_h, got_p, want_h, want_p = run_both(hf, ids, lens)
    _assert_close(got_h, got_p, want_h, want_p, lens)


def test_longformer_global_tokens_parity():
    """Global tokens: everyone attends them, their rows recompute with the
    *_global projections over the full sequence."""
    hf = make_hf(seed=2, window=4)
    rng = np.random.RandomState(3)
    ids = rng.randint(2, 96, size=(2, 18)).astype(np.int64)
    lens = np.array([18, 11], np.int32)
    got_h, got_p, want_h, want_p = run_both(
        hf, ids, lens, global_rows=[(0, 0), (0, 9), (1, 0)]
    )
    _assert_close(got_h, got_p, want_h, want_p, lens)


def test_longformer_per_layer_windows():
    """attention_window as a per-layer list."""
    hf = make_hf(seed=4, window=[4, 8], layers=2)
    rng = np.random.RandomState(5)
    ids = rng.randint(2, 96, size=(1, 16)).astype(np.int64)
    lens = np.array([16], np.int32)
    got_h, got_p, want_h, want_p = run_both(hf, ids, lens)
    _assert_close(got_h, got_p, want_h, want_p, lens)


def test_longformer_window_actually_limits_attention():
    """Sanity that the pattern is really windowed: a far-away token edit must
    NOT change position 0's hidden state in a 1-layer model (outside the
    window), but a within-window edit must."""
    hf = make_hf(seed=6, window=4, layers=1)
    cfg = config_from_hf_longformer(hf.config)
    params = params_from_hf_longformer_state_dict(cfg, hf.state_dict())
    rng = np.random.RandomState(7)
    ids = rng.randint(2, 96, size=(1, 24)).astype(np.int32)
    lens = jnp.asarray([24], jnp.int32)
    base, _ = encode(cfg, params, jnp.asarray(ids), lens)
    far = ids.copy()
    far[0, 20] = (far[0, 20] + 1) % 94 + 2  # outside window of position 0
    far_h, _ = encode(cfg, params, jnp.asarray(far), lens)
    np.testing.assert_allclose(base[0, 0], far_h[0, 0], rtol=1e-6)
    near = ids.copy()
    near[0, 2] = (near[0, 2] + 1) % 94 + 2  # inside the +/-2 window
    near_h, _ = encode(cfg, params, jnp.asarray(near), lens)
    assert np.abs(np.asarray(base[0, 0]) - np.asarray(near_h[0, 0])).max() > 1e-6


def test_longformer_registry():
    from fastertransformer4codefuse_tpu.models import registry

    fam = registry.get("longformer")
    hf = make_hf(seed=0)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict())
    rng = np.random.RandomState(0)
    ids = rng.randint(2, 96, size=(1, 12)).astype(np.int32)
    h, p = fam.encode(cfg, params, jnp.asarray(ids), jnp.asarray([12]))
    assert h.shape == (1, 12, 32) and p.shape == (1, 32)


@pytest.mark.parametrize("w", [2, 7, 16])
def test_local_attention_matches_bruteforce(w):
    """The dense-masked band (no global tokens) against a float64
    brute-force softmax over the band, across window sizes and ragged
    padding (the shapes the removed banded-kernel test used)."""
    from fastertransformer4codefuse_tpu.models.longformer import _local_attention

    rng = np.random.RandomState(0)
    B, S, nH, dh = 2, 40, 4, 16
    q = rng.randn(B, S, nH, dh).astype(np.float32) * 0.3
    k = rng.randn(B, S, nH, dh).astype(np.float32) * 0.3
    v = rng.randn(B, S, nH, dh).astype(np.float32)
    lens = np.array([40, 23], np.int32)
    is_masked = np.arange(S)[None, :] >= lens[:, None]
    i = np.arange(S)
    band = np.abs(i[:, None] - i[None, :]) <= w
    allow = band[None] & ~is_masked[:, None, :]
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k)
    scores = np.where(allow[:, None], scores, -1e30)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", probs, v)
    want = np.where(is_masked[:, :, None, None], 0.0, want)
    got = _local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w,
        jnp.asarray(is_masked), jnp.zeros((B, S), bool),
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-6)


def test_longformer_encode_jit_matches_eager():
    """encode under jax.jit equals the eager call, with and without global
    tokens."""
    import functools

    import jax

    hf = make_hf(seed=9, window=4, layers=1)
    cfg = config_from_hf_longformer(hf.config)
    params = params_from_hf_longformer_state_dict(cfg, hf.state_dict())
    rng = np.random.RandomState(10)
    ids = rng.randint(2, 96, size=(1, 16)).astype(np.int32)
    lens = jnp.asarray([16], jnp.int32)
    jitted = jax.jit(functools.partial(encode, cfg))
    h1, _ = jitted(params, jnp.asarray(ids), lens)
    ref1, _ = encode(cfg, params, jnp.asarray(ids), lens)
    np.testing.assert_allclose(
        np.asarray(h1), np.asarray(ref1), rtol=2e-4, atol=2e-5
    )
    gm = np.zeros((1, 16), bool)
    gm[0, 0] = True
    h2, _ = jitted(params, jnp.asarray(ids), lens, global_mask=jnp.asarray(gm))
    ref2, _ = encode(cfg, params, jnp.asarray(ids), lens,
                     global_mask=jnp.asarray(gm))
    np.testing.assert_allclose(
        np.asarray(h2), np.asarray(ref2), rtol=2e-4, atol=2e-5
    )
