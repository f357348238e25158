"""Fused-loop streaming (ordered io_callback inside the jitted while_loop):
message content must be byte-identical to the non-streaming outputs, with the
reference's callback message format and per-row repeat semantics
(pybind_callback_utils.cc:79-99)."""
import numpy as np

from fastertransformer4codefuse_tpu import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    init_params,
)


def make_engine(seed=0):
    cfg = GptNeoXConfig.tiny(vocab_size=70)
    import jax

    params = init_params(cfg, rng=jax.random.PRNGKey(seed), dtype="fp32")
    return cfg, GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=8))


PROMPTS = [[3, 4, 5], [9, 8, 7, 6]]


def test_stream_matches_batch_greedy():
    cfg, eng = make_engine()
    ref = eng.generate(PROMPTS, output_len=6, top_k=1)
    msgs = []
    out = eng.generate(PROMPTS, output_len=6, top_k=1, callback=msgs.append)
    np.testing.assert_array_equal(out.output_ids, ref.output_ids)
    assert len(msgs) == 6
    for b, p in enumerate(PROMPTS):
        toks = [m["last_tokens"][b][0] for m in msgs]
        assert toks == list(ref.output_ids[b, 0, len(p) : len(p) + 6])
        idxs = [m["idxs"][b][0] for m in msgs]
        assert idxs == list(range(6))


def test_stream_matches_batch_sampled():
    cfg, eng = make_engine(seed=1)
    kw = dict(top_k=[5, 3], top_p=[0.9, 0.0], temperature=0.8, random_seed=[7, 8])
    ref = eng.generate(PROMPTS, output_len=5, **kw)
    msgs = []
    out = eng.generate(PROMPTS, output_len=5, callback=msgs.append, **kw)
    np.testing.assert_array_equal(out.output_ids, ref.output_ids)
    assert len(msgs) == 5


def test_stream_early_stop_and_repeat_semantics():
    """Rows that finish early keep appearing with end_id and a stale idx (the
    reference's last_seq_length forcing); the loop exits when all rows are
    done, so the message count equals the executed steps."""
    cfg, eng = make_engine(seed=2)
    ref = eng.generate(PROMPTS, output_len=6, top_k=1)
    # stop row 0 after its first generated token; row 1 runs to 6
    sw = np.array(
        [[[int(ref.output_ids[0, 0, 3])], [1]], [[-1], [-1]]], np.int32
    )
    msgs = []
    out = eng.generate(
        PROMPTS, output_len=6, top_k=1, stop_words_list=sw, callback=msgs.append
    )
    assert len(msgs) == 6
    assert out.sequence_lengths[0, 0] == 4
    end_id = cfg.end_id
    row0 = [m["last_tokens"][0][0] for m in msgs]
    assert row0[0] == ref.output_ids[0, 0, 3]
    assert all(t == end_id for t in row0[1:])
    idx0 = [m["idxs"][0][0] for m in msgs]
    assert idx0 == [0] + [0] * 5  # stale idx repeats
    # the still-running row streams normally
    row1 = [m["last_tokens"][1][0] for m in msgs]
    assert row1 == list(out.output_ids[1, 0, 4:10])


def test_stream_messages_match_output_rows():
    """The fused loop's io_callback messages carry, step by step, exactly the
    tokens the returned buffer holds for every row."""
    cfg, eng = make_engine(seed=3)
    msgs = []
    out = eng.generate(PROMPTS, output_len=6, top_k=1, callback=msgs.append)
    ref = eng.generate(PROMPTS, output_len=6, top_k=1)
    np.testing.assert_array_equal(out.output_ids, ref.output_ids)
    for b, p in enumerate(PROMPTS):
        n = int(out.sequence_lengths[b, 0]) - len(p)
        row = [m["last_tokens"][b][0] for m in msgs][:n]
        assert row == list(out.output_ids[b, 0, len(p): len(p) + n])


def test_stream_callback_order_is_step_order():
    """Messages arrive in generation order: each row's idx counts up by one
    per step until the row finishes."""
    cfg, eng = make_engine(seed=4)
    msgs = []
    eng.generate(PROMPTS, output_len=5, top_k=1, callback=msgs.append)
    assert len(msgs) == 5
    for b in range(len(PROMPTS)):
        idx = [m["idxs"][b][0] for m in msgs]
        assert idx == sorted(idx) and idx[0] == 0
