"""Beam search: structure, score ordering, stop criteria
(the analog of the reference's beam layer tests and the input_demo.jsonl
beam_width=3 smoke, SURVEY §4)."""
import numpy as np
import pytest

from fastertransformer4codefuse_tpu import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    init_params,
)


def make_engine(seed=0):
    cfg = GptNeoXConfig.tiny(head_num=4, size_per_head=8, vocab_size=64)
    import jax

    params = init_params(cfg, rng=jax.random.PRNGKey(seed), dtype="fp32")
    return cfg, GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=4))


def test_beam_shapes_and_order():
    cfg, eng = make_engine()
    prompts = [[3, 4, 5], [9, 8, 7, 6]]
    out = eng.generate(prompts, output_len=5, beam_width=3)
    assert out.output_ids.shape[:2] == (2, 3)
    assert out.output_ids.shape[2] >= 4 + 5
    assert out.sequence_lengths.shape == (2, 3)
    assert out.cum_log_probs.shape == (2, 3)
    # beams sorted best-first by (unpenalized, len_penalty=0) cumulative score
    for b in range(2):
        s = out.cum_log_probs[b]
        assert (np.diff(s) <= 1e-5).all(), s
    # prompt preserved in every beam
    for b, p in enumerate(prompts):
        for j in range(3):
            assert list(out.output_ids[b, j, : len(p)]) == p


def test_beam_beats_or_matches_greedy():
    """The best beam's cumulative log prob must be >= greedy's (same model)."""
    cfg, eng = make_engine(seed=1)
    prompts = [[5, 6, 7]]
    greedy = eng.generate(
        prompts, output_len=6, top_k=1, return_cum_log_probs=True
    )
    beam = eng.generate(prompts, output_len=6, beam_width=4)
    assert beam.cum_log_probs[0, 0] >= greedy.cum_log_probs[0, 0] - 1e-4


def test_beam_distinct_hypotheses():
    cfg, eng = make_engine(seed=2)
    out = eng.generate([[3, 4, 5, 6]], output_len=6, beam_width=3)
    rows = [tuple(r) for r in out.output_ids[0, :, 4:10]]
    assert len(set(rows)) > 1, "beams all collapsed to one hypothesis"


def test_beam_stop_words():
    cfg, eng = make_engine(seed=3)
    g = eng.generate([[3, 4, 5]], output_len=5, beam_width=2)
    first_tok = int(g.output_ids[0, 0, 3])
    sw = np.array([[[first_tok], [1]]], np.int32)
    out = eng.generate([[3, 4, 5]], output_len=5, beam_width=2, stop_words_list=sw)
    # the beam that picked first_tok stops right after it
    lens = out.sequence_lengths[0]
    toks = out.output_ids[0]
    for j in range(2):
        if toks[j, 3] == first_tok:
            assert lens[j] == 4


def test_beam_streaming_matches_batch():
    cfg, eng = make_engine(seed=4)
    prompts = [[3, 4, 5, 6]]
    batch = eng.generate(prompts, output_len=5, beam_width=2)
    events = []
    stream = eng.generate(
        prompts, output_len=5, beam_width=2,
        callback=lambda m: events.append(m),
    )
    assert len(events) >= 1
    assert all(len(e["last_tokens"][0]) == 2 for e in events)
    # final outputs identical between modes
    np.testing.assert_array_equal(batch.output_ids, stream.output_ids)
    np.testing.assert_array_equal(batch.sequence_lengths, stream.sequence_lengths)


@pytest.mark.parametrize("nKV", [4, 2])  # MHA and grouped-query (GQA)
def test_attend_decode_beam_matches_physical_gather(nKV):
    """Op-level: indirection-resolved attention == attention over a physically
    reordered cache, for both bf16 and int8(+scales) caches, MHA and GQA."""
    import jax
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu.engine import kv_cache as kvc

    rng = np.random.default_rng(0)
    L, B, bw, nH, S, dh = 2, 2, 3, 4, 16, 8
    BB = B * bw
    q = jnp.asarray(rng.normal(size=(BB, nH, dh)), jnp.float32)
    lens = rng.integers(5, S, size=(BB,))
    valid = jnp.asarray(np.arange(S)[None, :] < lens[:, None])
    indir = jnp.asarray(rng.integers(0, bw, size=(BB, S)), jnp.int32)
    layer = jnp.int32(1)

    for quant in (False, True):
        if quant:
            cache = {
                "k": jnp.asarray(rng.integers(-127, 128, size=(L, BB, nKV, S, dh)), jnp.int8),
                "v": jnp.asarray(rng.integers(-127, 128, size=(L, BB, nKV, S, dh)), jnp.int8),
                "k_s": jnp.asarray(rng.uniform(0.01, 0.1, size=(L, BB, nKV, S)), jnp.bfloat16),
                "v_s": jnp.asarray(rng.uniform(0.01, 0.1, size=(L, BB, nKV, S)), jnp.bfloat16),
            }
        else:
            cache = {
                "k": jnp.asarray(rng.normal(size=(L, BB, nKV, S, dh)), jnp.float32),
                "v": jnp.asarray(rng.normal(size=(L, BB, nKV, S, dh)), jnp.float32),
            }
        got = kvc.attend_decode_beam(cache, layer, q, valid, 0.3, indir, bw)

        # physically resolve the indirection per position, then vanilla attend
        ind = np.asarray(indir).reshape(B, bw, S)
        resolved = {}
        for name, slab in cache.items():
            arr = np.asarray(slab).reshape((L, B, bw) + slab.shape[2:])
            out = np.empty_like(np.asarray(slab).reshape((L, B, bw) + slab.shape[2:]))
            for b in range(B):
                for j in range(bw):
                    for s_ in range(S):
                        out[:, b, j, :, s_] = arr[:, b, ind[b, j, s_], :, s_]
            resolved[name] = jnp.asarray(out.reshape(np.asarray(slab).shape))
        want = kvc.attend_decode(resolved, layer, q, valid, 0.3)
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(want, np.float32),
            rtol=2e-4, atol=2e-4,
        )


def test_beam_gqa_llama_end_to_end():
    """Beam search over a GQA (nKV < nH) LLaMA-family model — the reference
    decode kernel handles beams for any head layout via its cache_indir +
    kv_head_num params (decoder_masked_multihead_attention.h); this pins the
    indirection formulation end-to-end including teacher-forced rescoring
    of every returned hypothesis."""
    import jax
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu.models import gptneox as model

    cfg = GptNeoXConfig.tiny(
        head_num=4, size_per_head=8, vocab_size=64, kv_head_num=2,
        qkv_layout="concat", norm="rmsnorm", gated_ffn=True, use_bias=False,
        activation="silu",
    )
    params = init_params(cfg, rng=jax.random.PRNGKey(7), dtype="fp32")
    eng = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=4))

    prompt = [3, 4, 5, 6]
    out = eng.generate([prompt], output_len=6, beam_width=3)
    assert out.output_ids.shape[:2] == (1, 3)
    s = out.cum_log_probs[0]
    assert (np.diff(s) <= 1e-5).all(), s
    greedy = eng.generate(
        [prompt], output_len=6, top_k=1, return_cum_log_probs=True
    )
    assert out.cum_log_probs[0, 0] >= greedy.cum_log_probs[0, 0] - 1e-4

    # teacher-forced rescoring: each hypothesis' cum_log_prob must equal the
    # sum of its token log-probs under the model (any GQA indirection bug in
    # attend_decode_beam shifts the logits and breaks this)
    for j in range(3):
        seq = list(out.output_ids[0, j, : out.sequence_lengths[0, j]])
        T = len(seq)
        cache = model.init_kv_cache(cfg, 1, T, jnp.float32)
        ids = jnp.asarray([seq], jnp.int32)
        hidden, _ = model.prefill(cfg, params, ids, jnp.asarray([T], jnp.int32), cache)
        lp = jax.nn.log_softmax(model.lm_logits(cfg, params, hidden)[0], axis=-1)
        want = sum(float(lp[t - 1, seq[t]]) for t in range(len(prompt), T))
        assert abs(float(out.cum_log_probs[0, j]) - want) < 1e-3


def test_beam_cum_log_probs_match_teacher_forced_rescoring():
    """End-to-end pin on the fixed-cache indirection machinery: every returned
    hypothesis' cum_log_prob must equal the teacher-forced sum of token
    log-probs under the model. Any cache-lineage corruption (e.g. a finished
    row's rewrite clobbering a slot other beams still reference) would shift
    the sampled logits and break this equality. Stop-words force beams to
    finish at different times, exercising the hazard path."""
    import jax
    import jax.numpy as jnp

    from fastertransformer4codefuse_tpu.models import gptneox as model

    cfg, eng = make_engine(seed=5)
    prompt = [3, 4, 5, 6]
    g = eng.generate([prompt], output_len=8, beam_width=3)
    first_toks = {int(t) for t in g.output_ids[0, :, len(prompt)]}
    # stop on one beam's first pick so beams finish at different steps
    sw = np.array([[[sorted(first_toks)[0]], [1]]], np.int32)
    out = eng.generate([prompt], output_len=8, beam_width=3, stop_words_list=sw)

    params = eng.params
    end_id = cfg.end_id
    for j in range(3):
        seq = list(out.output_ids[0, j, : out.sequence_lengths[0, j]])
        T = len(seq)
        cache = model.init_kv_cache(cfg, 1, T, jnp.float32)
        ids = jnp.asarray([seq], jnp.int32)
        hidden, _ = model.prefill(cfg, params, ids, jnp.asarray([T], jnp.int32), cache)
        logits = model.lm_logits(cfg, params, hidden)  # [1, T, V]
        lp = jax.nn.log_softmax(logits[0], axis=-1)
        want = sum(
            float(lp[t - 1, seq[t]]) for t in range(len(prompt), T)
        )
        got = float(out.cum_log_probs[0, j])
        assert abs(got - want) < 1e-3, (j, got, want, seq)
