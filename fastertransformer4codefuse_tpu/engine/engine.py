"""Generation engine: prefill + incremental decode with full sampling stack.

A rebuild of the reference engine loop
(/root/reference/src/fastertransformer/models/gptneox/GptNeoX.cc:386-1052):
prefill (context decoder) -> per-token decode loop -> dynamic decode
(sampling + stop criteria) -> early stop. The whole generation is one jitted
program with a ``lax.while_loop`` over steps (early-exit on all-finished, the
analog of GptNeoX.cc:1031-1033), so no token makes a host round trip. With a
``callback`` the same loop emits each step's newest tokens through an ordered
``io_callback`` — the analog of the reference's per-step pybind callback
(pybind_callback_utils.cc:36-102), where only the [B] newest-token vector
crosses to the host.

Design departure from the reference: ragged batches are packed contiguously
per row (new token b lands in cache slot ``seq_lens[b]``) instead of
right-padding with dead masked slots (the reference's ``masked_tokens``
scheme). Rotary positions stay contiguous per sequence — numerics match
unbatched decoding exactly — the KV cache has no holes, and outputs need no
gather_tree-style compaction (decoding_kernels.cu gatherTree).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import GptNeoXConfig, RuntimeConfig
from ..core.dtypes import jnp_dtype
from ..models import gptneox as model
from ..models.params import Params, QuantizedTensor
from ..sampling import processors as proc
from ..sampling.sample import (
    sample_greedy,
    sample_top_k_top_p,
    sample_top_k_top_p_capped,
)
from ..ops import routes


class DecodeState(NamedTuple):
    tokens: jax.Array  # [B, T] int32 — packed sequence buffer
    seq_lens: jax.Array  # [B] int32 — current real length per row
    gen_step: jax.Array  # scalar int32 — tokens generated so far
    finished: jax.Array  # [B] bool
    cum_log_probs: jax.Array  # [B] f32
    base_keys: jax.Array  # [B] PRNG keys (per-sample seeds, FT-style)
    logits: jax.Array  # [B, V] f32 — logits for the NEXT sample
    cache: Any  # stacked KV cache pytree (engine.kv_cache)
    newest: jax.Array  # [B] int32 — token sampled this step (for streaming)
    beam_indir: Any = None  # [B, S] int32 — beam-search cache indirection (beam only)
    pos_offset: Any = None  # [B] int32 — cache-slot/rotary offset of buffer
    # index 0 (prompt-learning prefixes occupy cache slots [0, offset))
    step_log_probs: Any = None  # [B, out_len] f32 — per-step token log-probs
    # (only when requested; the reference's optional output_log_probs tensor)


@dataclasses.dataclass(frozen=True)
class _Statics:
    """Hashable static trace parameters; one compiled program per value."""

    batch: int
    input_width: int
    total_len: int
    output_len: int
    greedy: bool
    use_temperature: bool
    use_rep_penalty: bool
    use_pres_penalty: bool
    use_min_length: bool
    use_stop_words: bool
    use_bad_words: bool
    use_optional_last: bool
    sampling_cap: int  # 0 = full-sort sampling; >0 = lax.top_k(cap) fast path
    stop_words_len: int
    bad_words_len: int
    optional_last_count: int
    prompt_width: int = 0  # padded prompt length P (0 = no prompt learning)
    prompt_kind: str = "none"  # "none" | "prefix" | "soft"
    use_output_log_probs: bool = False  # return per-step token log-probs
    # Compute cum_log_probs (full-vocab normalization per step). Default OFF —
    # the reference's op-level contract (codefuse_example.py:560
    # return_cum_log_probs=0 skips the softmax+log kernel pass,
    # sampling_topk_kernels.cu:271-292); its Python generate() turns it on.
    use_cum_log_probs: bool = False


def _pad_to(x: np.ndarray, width: int, axis: int, value) -> np.ndarray:
    pad = width - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


class GenerationOutput(NamedTuple):
    output_ids: np.ndarray  # [B, beam, T] int32, packed (input + generated + end pad)
    sequence_lengths: np.ndarray  # [B, beam] int32 (input + generated incl. end token)
    cum_log_probs: np.ndarray  # [B, beam] f32
    # per-step log-prob of each generated token (0 past finish), only when
    # requested via generate(output_log_probs=True) — the reference's optional
    # output_log_probs tensor (GptNeoX.cc output map; kernels/logprob_kernels.cu).
    # For beam search the buffer follows each hypothesis' reorder path, so
    # output_log_probs.sum(-1) == cum_log_probs per returned hypothesis.
    output_log_probs: Optional[np.ndarray] = None  # [B, beam, out_len] f32


class GptNeoXEngine:
    """Host-facing engine. Owns jit caches keyed on static shape/flag bundles.

    The analog of the reference's FTGptNeoX wrapper + ft::GptNeoX engine
    (th_op/gptneox/GptNeoXOp.h:246-381) with the request-level knobs of
    GptNeoX.forward (codefuse_example.py:545-601).
    """

    def __init__(
        self,
        config: GptNeoXConfig,
        params: Params,
        runtime: Optional[RuntimeConfig] = None,
        mesh: Optional[jax.sharding.Mesh] = None,
    ):
        self.config = config
        self.runtime = runtime or RuntimeConfig()
        self.mesh = mesh
        self.params = params
        self._generate_cache: Dict[_Statics, Callable] = {}
        # The routes this engine's programs are traced with (ops/routes.py).
        # The GPU routes (cuDNN prefill attention, the Triton decode-attention
        # kernel and the int8 GEMV) exist only on the GPU; elsewhere the same
        # math runs as plain XLA. cuDNN prefill only behind float
        # projections: after an int8 Triton GEMM in the same program, XLA's
        # compiled prefill returned inf (H100, jax 0.9.0; PERF.md). The
        # Triton kernels are custom calls GSPMD cannot split over a mesh, so
        # sharded engines keep XLA's attention and GEMMs.
        on_gpu = jax.default_backend() == "gpu"
        quantized = any(
            isinstance(v, QuantizedTensor) for v in params["layers"].values()
        )
        self.routes = routes.Routes(
            flash_prefill=self.runtime.use_flash_prefill and on_gpu and not quantized,
            flash_decode=self.runtime.use_flash_decode and on_gpu and mesh is None,
            int8_gemv=on_gpu and mesh is None,
            act_int8=self.runtime.act_int8,
        )
        # XLA's Triton GEMM fusions of int8 weights computed NaN in the
        # chunked prefill of a TP=4 engine, from the second layer on (H100,
        # jax 0.9.0); its one-shot prefill, and bf16 weights with an int8 KV
        # cache, were right (PERF.md). Sharded engines with int8 weights
        # compile their programs with XLA's other GEMM emitters.
        sharded = mesh is not None and mesh.size > 1
        self.compiler_options = (
            {"xla_gpu_enable_triton_gemm": False} if on_gpu and sharded and quantized else {}
        )
        self._pp = 1
        # Prompt-learning task table: {task_id: (kv [L, 2, nH, P, dh], length)}
        # — the analog of gpt_weights->prompt_learning_table (GptNeoX.cc:483-501)
        self._prompt_table: Dict[int, Tuple[np.ndarray, int]] = {}
        if mesh is not None:
            from ..parallel.sharding import shard_params

            self.params = shard_params(config, self.params, mesh)
            self._pp = int(dict(mesh.shape).get("pp", 1))
            if self._pp > 1:
                assert config.layer_num % self._pp == 0

    def check_speculation(self) -> None:
        """Refuse speculative decoding (one-shot and pooled) under a
        multi-device mesh on the GPU: it was not run on the cards, and the
        one-shot programs are module-level jits that take the routes but not
        the engine's ``compiler_options``."""
        if self.mesh is not None and self.mesh.size > 1 and jax.default_backend() == "gpu":
            raise NotImplementedError(
                "speculative decoding under a multi-device mesh is not brought "
                "up on the GPU; speculate on one card"
            )

    def jit(self, fn: Callable, **jit_kwargs) -> Callable:
        """``jax.jit`` of one of this engine's programs: ``fn`` is traced
        under the engine's routes (read at trace time, so a caller may swap
        ``self.routes`` before the first call)."""

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with routes.use(self.routes):
                return fn(*args, **kwargs)

        if self.compiler_options:
            jit_kwargs = {"compiler_options": self.compiler_options, **jit_kwargs}
        return jax.jit(traced, **jit_kwargs)

    # ------------------------------------------------------------ prompts --
    def set_prompt_learning_table(self, table: Dict[int, Tuple[np.ndarray, int]]):
        """Register prefix-prompt weights per task id.

        ``table[task_id] = (kv, length)`` with kv ``[L, 2, nH, P, dh]`` — the
        saved per-layer key/value states of a tuned prefix (the reference's
        prompt_learning_table, utils/prompt_learning.h + GptNeoX.cc:483-501).
        Requests select a task via ``prompt_learning_task_name_ids``."""
        cfg = self.config
        for tid, (kv, length) in table.items():
            kv = np.asarray(kv)
            assert kv.ndim == 5 and kv.shape[:3] == (cfg.layer_num, 2, cfg.head_num), (
                tid, kv.shape)
            assert kv.shape[4] == cfg.size_per_head and kv.shape[3] >= length
        self._prompt_table = {t: (np.asarray(kv), int(n)) for t, (kv, n) in table.items()}

    def _prepare_prompt(self, B, task_ids, soft_embedding, soft_lengths):
        """Build the per-request prompt arrays. Returns (kind, width, extras)."""
        cfg = self.config
        if task_ids is not None:
            assert soft_embedding is None, "prefix and soft prompts are exclusive"
            task_ids = list(task_ids)
            assert len(task_ids) == B
            lens = np.array([self._prompt_table[t][1] for t in task_ids], np.int32)
            P = max(int(lens.max()), 1)
            P = -(-P // 8) * 8  # pad to bucket retraces (tail slots never valid)
            k_pre = np.zeros((cfg.layer_num, B, cfg.head_num, P, cfg.size_per_head), np.float32)
            v_pre = np.zeros_like(k_pre)
            for b, t in enumerate(task_ids):
                kv, n = self._prompt_table[t]
                k_pre[:, b, :, :n] = kv[:, 0, :, :n]
                v_pre[:, b, :, :n] = kv[:, 1, :, :n]
            return "prefix", P, {
                "prefix_k": jnp.asarray(k_pre),
                "prefix_v": jnp.asarray(v_pre),
                "prompt_lengths": jnp.asarray(lens),
            }
        if soft_embedding is not None:
            emb = np.asarray(soft_embedding, np.float32)  # [B, P, H]
            assert emb.ndim == 3 and emb.shape[0] == B and emb.shape[2] == cfg.hidden_size
            if soft_lengths is None:
                lens = np.full((B,), emb.shape[1], np.int32)
            else:
                lens = np.asarray(soft_lengths, np.int32)
            P = -(-emb.shape[1] // 8) * 8
            emb = _pad_to(emb, P, 1, 0.0)
            return "soft", P, {
                "prompt_embeds": jnp.asarray(emb),
                "prompt_lengths": jnp.asarray(lens),
            }
        return "none", 0, {}

    # ------------------------------------------------------------------ core --
    def _cache_dtype(self):
        name = self.runtime.kv_cache_dtype or self.runtime.dtype
        if name in ("int4", "int8k_int4v"):  # packed modes (kv_cache.init_cache)
            return name
        return jnp_dtype(name)

    def _sample_and_advance(self, st: _Statics, params: Params, inputs: Dict[str, jax.Array], s: DecodeState) -> DecodeState:
        """One generation step: process logits -> sample -> criteria -> forward.

        Order of logit processors mirrors DynamicDecodeLayer.cc:192-497 and
        BaseSamplingLayer penalties: optional-last-tokens (first step only) ->
        ban-bad-words -> temperature -> repetition/presence penalty ->
        min-length -> top-k/top-p draw.
        """
        cfg = self.config
        end_id = cfg.end_id
        B, T = s.tokens.shape

        logits = s.logits
        if st.use_optional_last:
            logits = proc.apply_optional_last_tokens(
                logits, inputs["optional_last_tokens"], 1, s.gen_step == 0
            )
        if st.use_bad_words:
            logits = proc.ban_bad_words(
                logits, s.tokens, s.seq_lens, inputs["bad_words"], 1
            )
        if st.use_temperature:
            logits = proc.apply_temperature(logits, inputs["temperature"])
        if st.use_rep_penalty or st.use_pres_penalty:
            buf_valid = jnp.arange(T)[None, :] < s.seq_lens[:, None]
            if st.use_rep_penalty:
                logits = proc.apply_repetition_penalty(
                    logits, s.tokens, buf_valid, inputs["repetition_penalty"]
                )
            if st.use_pres_penalty:
                logits = proc.apply_presence_penalty(
                    logits, s.tokens, buf_valid, inputs["presence_penalty"]
                )
        if st.use_min_length:
            gen_lens = s.seq_lens - inputs["input_lengths"]
            logits = proc.apply_min_length(
                logits, gen_lens, inputs["min_length"], end_id
            )

        need_lp = st.use_cum_log_probs or st.use_output_log_probs
        if st.greedy:
            res = sample_greedy(logits, need_log_probs=need_lp)
        else:
            rngs = jax.vmap(jax.random.fold_in)(s.base_keys, jnp.full((B,), s.gen_step))
            if st.sampling_cap:
                res = sample_top_k_top_p_capped(
                    rngs, logits, inputs["top_k"], inputs["top_p"],
                    cap=st.sampling_cap, need_log_probs=need_lp,
                )
            else:
                res = sample_top_k_top_p(
                    rngs, logits, inputs["top_k"], inputs["top_p"],
                    need_log_probs=need_lp,
                )

        tok = jnp.where(s.finished, end_id, res.tokens)
        lp = jnp.where(s.finished, 0.0, res.log_probs)

        write_idx = jnp.clip(s.seq_lens, 0, T - 1)
        tokens = s.tokens.at[jnp.arange(B), write_idx].set(
            jnp.where(s.finished, s.tokens[jnp.arange(B), write_idx], tok)
        )
        seq_lens = s.seq_lens + jnp.where(s.finished, 0, 1)
        cum_log_probs = s.cum_log_probs + lp

        newly_finished = tok == end_id
        if st.use_stop_words:
            newly_finished = newly_finished | proc.stop_words_criterion(
                tokens, seq_lens, inputs["stop_words"], 1
            )
        finished = s.finished | newly_finished
        gen_step = s.gen_step + 1

        step_log_probs = s.step_log_probs
        if st.use_output_log_probs:
            step_log_probs = jax.lax.dynamic_update_index_in_dim(
                step_log_probs, lp, s.gen_step, axis=1
            )

        return s._replace(
            tokens=tokens,
            seq_lens=seq_lens,
            gen_step=gen_step,
            finished=finished,
            cum_log_probs=cum_log_probs,
            newest=tok,
            step_log_probs=step_log_probs,
        )

    def _forward_newest(
        self, st: _Statics, params: Params, s: DecodeState, beam_width: int = 1
    ) -> DecodeState:
        """Decode-forward the newest token, producing logits for the next sample.

        Kept OUT of any lax.cond: a conditional over the cache pytree breaks
        XLA's buffer aliasing and copies the entire KV cache every step. The
        generation loop instead runs
        ``output_len - 1`` sample+forward iterations and a final sample-only
        step, so no forward is ever wasted.

        With ``beam_width > 1`` the KV cache is FIXED and attention resolves
        ``s.beam_indir`` (the reference's cache_indirection scheme,
        GptNeoX.cc:776-778, 1011-1017). Finished rows' rewrites are
        redirected to slot S-1 (``sacrifice_last``): after a reorder the
        hypothesis occupying slot r differs from the lineage that wrote row
        r's slab, so writing at the frozen position would clobber bytes other
        beams still reference through the indirection (the teacher-forced
        rescoring test catches exactly this). S-1 is safe: sacrifice writes
        are row-local, and any hypothesis that reaches position S-1 writes it
        itself in the same layer step BEFORE attending over it; the byte-exact
        "preserve" alternative costs a read-modify-write gather per layer.
        """
        cfg = self.config
        B, T = s.tokens.shape
        buf_idx = jnp.clip(s.seq_lens - 1, 0, T - 1)
        newest = s.tokens[jnp.arange(B), buf_idx]
        # cache slot / rotary position = buffer index + prompt prefix offset
        positions = buf_idx if s.pos_offset is None else buf_idx + s.pos_offset
        beam = (beam_width, s.beam_indir) if beam_width > 1 else None
        kv_skip = s.finished if beam_width > 1 else None
        if self._pp > 1:
            from ..parallel import pipeline

            M = self.runtime.pp_microbatches
            hidden, cache = pipeline.decode_step(
                cfg, self.mesh, params, newest, positions, s.cache,
                beam=beam, kv_skip=kv_skip, kv_skip_mode="sacrifice_last",
                microbatches=M if B % max(M, 1) == 0 else 1,
            )
        else:
            hidden, cache = model.decode_step(
                cfg, params, newest, positions, s.cache, beam=beam,
                kv_skip=kv_skip, kv_skip_mode="sacrifice_last",
            )
        logits = model.lm_logits(cfg, params, hidden)
        return s._replace(logits=logits, cache=cache)

    def _prefill_state(self, st: _Statics, params: Params, inputs: Dict[str, jax.Array]) -> DecodeState:
        cfg = self.config
        B = st.batch
        tokens = inputs["tokens"]  # [B, T] pre-filled buffer (input + end_id pad)
        input_lengths = inputs["input_lengths"]
        cache = model.init_kv_cache(
            cfg, B, st.total_len + st.prompt_width, self._cache_dtype()
        )
        pos_offset = None

        if st.prompt_width:
            # Prompt learning (reference: GptNeoX.cc:443-509). The prompt
            # occupies cache slots [0, p_len) per row; the input follows at
            # [p_len, p_len + in_len) with rotary positions offset by p_len
            # (unfused_attention_kernels.cu:1402 dst_kv_seq_idx).
            from .kv_cache import write_prefix

            if self._pp > 1:
                # pp path: same math, each stage prefills its own layer block
                # (the reference plumbs prompts through PP too,
                # GptNeoX.cc:443-509)
                from ..parallel import pipeline

                def chunk_fn(toks, p, cache, active, embeds=None):
                    return pipeline.prefill_chunk(
                        cfg, self.mesh, params, toks, p, cache, active,
                        embeds=embeds,
                    )
            else:
                def chunk_fn(toks, p, cache, active, embeds=None):
                    return model.prefill_chunk(
                        cfg, params, toks, p, cache, active, embeds=embeds
                    )

            pos_offset = inputs["prompt_lengths"]
            active = jnp.ones((B,), jnp.bool_)
            if st.prompt_kind == "prefix":
                cache = write_prefix(cache, inputs["prefix_k"], inputs["prefix_v"])
            else:  # soft: run the prompt embeddings through the stack at [0, P)
                emb = inputs["prompt_embeds"].astype(params["final_ln_w"].dtype)
                dummy = jnp.zeros((B, st.prompt_width), jnp.int32)
                _, cache = chunk_fn(
                    dummy, jnp.zeros((B,), jnp.int32), cache, active, embeds=emb
                )
            hidden, cache = chunk_fn(
                tokens[:, : st.input_width], pos_offset, cache, active
            )
        elif self._pp > 1:
            from ..parallel import pipeline

            M = self.runtime.pp_microbatches
            hidden, cache = pipeline.prefill(
                cfg, self.mesh, params, tokens[:, : st.input_width],
                input_lengths, cache,
                microbatches=M if st.input_width % max(M, 1) == 0 else 1,
            )
        else:
            hidden, cache = model.prefill(
                cfg, params, tokens[:, : st.input_width], input_lengths, cache
            )
        last_h = model.last_token_hidden(hidden, input_lengths)
        logits = model.lm_logits(cfg, params, last_h)

        base_keys = jax.vmap(jax.random.PRNGKey)(inputs["random_seed"])
        return DecodeState(
            tokens=tokens,
            seq_lens=input_lengths,
            gen_step=jnp.int32(0),
            finished=jnp.zeros((B,), jnp.bool_),
            cum_log_probs=jnp.zeros((B,), jnp.float32),
            base_keys=base_keys,
            logits=logits,
            cache=cache,
            newest=jnp.full((B,), cfg.end_id, jnp.int32),
            pos_offset=pos_offset,
            step_log_probs=(
                jnp.zeros((B, st.output_len), jnp.float32)
                if st.use_output_log_probs
                else None
            ),
        )

    # ------------------------------------------------------------ jit builders --
    def _get_generate_fn(self, st: _Statics):
        if st in self._generate_cache:
            return self._generate_cache[st]

        def run(params, inputs):
            s = self._prefill_state(st, params, inputs)

            def cond(s):
                return jnp.logical_and(
                    s.gen_step < st.output_len - 1,
                    jnp.logical_not(jnp.all(s.finished)),
                )

            def body(s):
                s = self._sample_and_advance(st, params, inputs, s)
                return self._forward_newest(st, params, s)

            s = jax.lax.while_loop(cond, body, s)
            # final token: sample only (no forward needed; also a no-op when the
            # loop exited early because every row already finished)
            s = self._sample_and_advance(st, params, inputs, s)
            return s.tokens, s.seq_lens, s.cum_log_probs, s.step_log_probs

        fn = self.jit(run)
        self._generate_cache[st] = fn
        return fn

    # --------------------------------------------------- fused-loop streaming --
    def _stream_sink(self, newest, seq_lens, valid, final):
        """Host side of the in-loop ordered io_callback: enqueue one step's
        newest tokens. Runs on the JAX callback thread while the device is
        still executing the fused generation loop."""
        q = getattr(self, "_active_stream_q", None)
        if q is not None:
            if bool(valid):
                q.put(("msg", np.asarray(newest), np.asarray(seq_lens)))
            if bool(final):
                q.put(("end", None, None))

    def _get_stream_fused_fn(self, st: _Statics):
        """Whole-generation jitted program that EMITS each step's tokens from
        inside the lax.while_loop via ordered io_callback — streaming without
        a per-token host dispatch+sync round-trip. Beats the reference's
        blocking per-step D2H callback (pybind_callback_utils.cc:36-76): the
        device never waits for the host; only [B] ints cross per step."""
        from jax.experimental import io_callback

        key = ("fused_stream", st)
        if key in self._generate_cache:
            return self._generate_cache[key]

        def emit(s, valid, final):
            io_callback(
                self._stream_sink, None,
                s.newest, s.seq_lens, valid, final, ordered=True,
            )

        def run(params, inputs):
            s = self._prefill_state(st, params, inputs)

            def cond(s):
                return jnp.logical_and(
                    s.gen_step < st.output_len - 1,
                    jnp.logical_not(jnp.all(s.finished)),
                )

            def body(s):
                s = self._sample_and_advance(st, params, inputs, s)
                emit(s, jnp.bool_(True), jnp.bool_(False))
                return self._forward_newest(st, params, s)

            s = jax.lax.while_loop(cond, body, s)
            # the final sample is a no-op when every row already finished —
            # suppress its message then (the stepwise loop broke before it)
            already_done = jnp.all(s.finished)
            s = self._sample_and_advance(st, params, inputs, s)
            emit(s, jnp.logical_not(already_done), jnp.bool_(True))
            return s.tokens, s.seq_lens, s.cum_log_probs, s.step_log_probs

        fn = self.jit(run)
        self._generate_cache[key] = fn
        return fn

    def _generate_streaming(self, st: _Statics, inputs, callback):
        """Run the fused streaming program, draining step messages to the
        user callback on the calling thread while the device computes."""
        import queue
        import threading

        fn = self._get_stream_fused_fn(st)
        q: "queue.Queue" = queue.Queue()
        self._active_stream_q = q
        in_lens = np.asarray(inputs["input_lengths"])
        try:
            results = fn(self.params, inputs)  # async dispatch

            def waiter():
                # fallback completion/error signal (the ordered "end" emit is
                # the primary one and always precedes buffer finalization)
                try:
                    jax.block_until_ready(results)
                    q.put(("end", None, None))
                except Exception as e:  # noqa: BLE001 — surfaced to caller
                    q.put(("err", e, None))

            threading.Thread(target=waiter, daemon=True).start()
            while True:
                kind, a, b = q.get()
                if kind == "msg":
                    cb_tokens = [[int(t)] for t in a]
                    cb_idxs = [
                        [int(b[i] - in_lens[i] - 1)] for i in range(st.batch)
                    ]
                    callback({"last_tokens": cb_tokens, "idxs": cb_idxs})
                elif kind == "err":
                    raise a
                else:
                    break
            return jax.device_get(results)
        finally:
            self._active_stream_q = None

    # -------------------------------------------------------------- host API --
    def _prepare(
        self,
        input_ids: Sequence[Sequence[int]],
        output_len: int,
        top_k=None,
        top_p=None,
        temperature=None,
        repetition_penalty=None,
        presence_penalty=None,
        min_length=None,
        random_seed=None,
        stop_words_list: Optional[np.ndarray] = None,
        bad_words_list: Optional[np.ndarray] = None,
        optional_last_tokens: Optional[np.ndarray] = None,
        prompt_learning_task_name_ids: Optional[Sequence[int]] = None,
        request_prompt_embedding: Optional[np.ndarray] = None,
        request_prompt_lengths: Optional[Sequence[int]] = None,
        output_log_probs: bool = False,
        return_cum_log_probs: bool = False,
    ) -> Tuple[_Statics, Dict[str, jax.Array]]:
        cfg = self.config
        rt = self.runtime
        B = len(input_ids)
        prompt_kind, prompt_width, prompt_inputs = self._prepare_prompt(
            B, prompt_learning_task_name_ids,
            request_prompt_embedding, request_prompt_lengths,
        )
        lengths = np.array([len(x) for x in input_ids], np.int32)
        assert (lengths > 0).all(), "input len must be larger than zero"
        max_in = int(lengths.max())
        # bucket the padded input width to bound retraces; packed layout keeps
        # per-row positions exact regardless of padding
        bucket = max(rt.seq_bucket, 1)
        input_width = min(-(-max_in // bucket) * bucket, max_in + bucket)
        input_width = max(input_width, max_in)
        total_len = input_width + int(output_len)
        if rt.kv_cache_dtype in ("int4", "int8k_int4v"):
            # packed caches pair sequence positions per byte: even widths only
            assert input_width % 2 == 0, (
                "int4 KV needs an even prefill width — use an even seq_bucket"
            )
            total_len += total_len % 2

        tokens = np.full((B, total_len), cfg.end_id, np.int32)
        for i, ids in enumerate(input_ids):
            tokens[i, : len(ids)] = np.asarray(ids, np.int32)

        def per_sample(v, default, dtype):
            if v is None:
                arr = np.full((B,), default, dtype)
            elif np.isscalar(v):
                arr = np.full((B,), v, dtype)
            else:
                arr = np.asarray(v, dtype)
                assert arr.shape == (B,)
            return arr

        top_k = per_sample(top_k, 1, np.int32)
        top_p = per_sample(top_p, 0.0, np.float32)
        temperature = per_sample(temperature, 1.0, np.float32)
        repetition_penalty = per_sample(repetition_penalty, 1.0, np.float32)
        presence_penalty = per_sample(presence_penalty, 0.0, np.float32)
        min_length = per_sample(min_length, 0, np.int32)
        if random_seed is None:
            random_seed = np.zeros((B,), np.uint32)
        else:
            random_seed = per_sample(random_seed, 0, np.uint32)

        greedy = bool((top_k == 1).all() and (top_p <= 0.0).all())
        # capped fast path when every row top-k's within a small static bound
        if (top_k > 0).all() and int(top_k.max()) <= 128:
            sampling_cap = max(64, 1 << int(top_k.max() - 1).bit_length())
        else:
            sampling_cap = 0

        def words_arr(w, pad_mult=4):
            if w is None:
                return np.zeros((B, 2, 1), np.int32), 0
            w = np.asarray(w, np.int32)
            assert w.ndim == 3 and w.shape[0] == B and w.shape[1] == 2
            L = max(-(-w.shape[2] // pad_mult) * pad_mult, 1)
            w = _pad_to(w, L, 2, -1)
            # pad value -1 for offsets; flat ids padding value is irrelevant
            return w, L

        stop_words, Lsw = words_arr(stop_words_list)
        bad_words, Lbw = words_arr(bad_words_list)
        if optional_last_tokens is None:
            olt, C = np.full((B, 1), -1, np.int32), 0
        else:
            olt = np.asarray(optional_last_tokens, np.int32)
            C = max(-(-olt.shape[1] // 4) * 4, 1)
            olt = _pad_to(olt, C, 1, -1)

        st = _Statics(
            batch=B,
            input_width=input_width,
            total_len=total_len,
            output_len=int(output_len),
            greedy=greedy,
            use_temperature=bool((temperature != 1.0).any()),
            use_rep_penalty=bool((repetition_penalty != 1.0).any()),
            use_pres_penalty=bool((presence_penalty != 0.0).any()),
            use_min_length=bool((min_length > 0).any()),
            use_stop_words=stop_words_list is not None,
            use_bad_words=bad_words_list is not None,
            use_optional_last=optional_last_tokens is not None,
            sampling_cap=sampling_cap,
            stop_words_len=Lsw,
            bad_words_len=Lbw,
            optional_last_count=C,
            prompt_width=prompt_width,
            prompt_kind=prompt_kind,
            use_output_log_probs=bool(output_log_probs),
            use_cum_log_probs=bool(return_cum_log_probs),
        )
        inputs = {
            "tokens": jnp.asarray(tokens),
            "input_lengths": jnp.asarray(lengths),
            "top_k": jnp.asarray(top_k),
            "top_p": jnp.asarray(top_p),
            "temperature": jnp.asarray(temperature),
            "repetition_penalty": jnp.asarray(repetition_penalty),
            "presence_penalty": jnp.asarray(presence_penalty),
            "min_length": jnp.asarray(min_length),
            "random_seed": jnp.asarray(random_seed),
            "stop_words": jnp.asarray(stop_words),
            "bad_words": jnp.asarray(bad_words),
            "optional_last_tokens": jnp.asarray(olt),
        }
        inputs.update(prompt_inputs)
        return st, inputs

    def generate(
        self,
        input_ids: Sequence[Sequence[int]],
        output_len: int,
        beam_width: int = 1,
        callback: Optional[Callable[[dict], None]] = None,
        beam_search_diversity_rate=None,  # beam-only; ignored for sampling (FT does too)
        len_penalty=None,  # beam-only
        **sampling_kwargs,
    ) -> GenerationOutput:
        """Batched generation. With ``callback`` set, streams each step's newest
        tokens as ``{"last_tokens": [[tok]*beam]*B, "idxs": [[gen_idx]*beam]*B}``
        (gen_idx = 0-based index within the generated region) — the reference's
        callback message format
        (th_op/gptneox/utils/pybind_callback_utils.cc:86-99)."""
        if self.runtime.debug_enabled():
            # FT_DEBUG_LEVEL=DEBUG analog: layer-attributed NaN/Inf sweep of
            # weights + a checkified prefill/decode step before generating.
            from ..utils.debug import debug_verify

            lens = np.array([len(x) for x in input_ids], np.int32)
            padded = np.full((len(input_ids), int(lens.max())), self.config.end_id, np.int32)
            for i, ids in enumerate(input_ids):
                padded[i, : len(ids)] = np.asarray(ids, np.int32)
            debug_verify(self, padded, lens)
        if beam_width != 1:
            from ..sampling.beam import beam_search_generate

            return beam_search_generate(
                self, input_ids, output_len, beam_width, callback=callback,
                beam_search_diversity_rate=beam_search_diversity_rate,
                len_penalty=len_penalty,
                **sampling_kwargs,
            )
        st, inputs = self._prepare(input_ids, output_len, **sampling_kwargs)

        if callback is None:
            fn = self._get_generate_fn(st)
            tokens, seq_lens, cum_lp, step_lp = jax.device_get(
                fn(self.params, inputs)
            )
        else:
            # Fused-loop streaming: the whole generation stays ONE jitted
            # while_loop; each step's newest [B] tokens surface through an
            # ordered io_callback (no per-token dispatch+sync round-trip).
            # Per-row repeat semantics match the reference's last_seq_length
            # logic (pybind_callback_utils.cc:79-88): finished rows keep
            # emitting end_id with a stale idx (newest is forced to end_id in
            # _sample_and_advance and seq_lens stops advancing).
            tokens, seq_lens, cum_lp, step_lp = self._generate_streaming(
                st, inputs, callback
            )

        return GenerationOutput(
            output_ids=tokens[:, None, :],
            sequence_lengths=seq_lens[:, None],
            cum_log_probs=cum_lp[:, None],
            output_log_probs=None if step_lp is None else step_lp[:, None, :],
        )
