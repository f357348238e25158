"""Serving handler: request-dict -> batched generation -> JSON response.

Rebuilds the reference's CodeFuseHandler + get_data_package
(codefuse_example.py:779-905) including per-prompt parameter gathering with
the same defaults (top_k=50, top_p=0, temperature=1, repetition_penalty=1),
streaming via per-(batch,beam) incremental detokenizers, and the response
schema {latency, random_seed, generated_code, length, cum_log_prob}.

Beyond the reference: with ``pool=dict(...)`` the handler routes requests
through a ContinuousBatcher slot pool (engine/server.py) — concurrent
``predict`` calls from different threads interleave mid-flight instead of
serializing whole static batches the way the reference's engine does
(GptNeoX.cc:386-1052 runs one batch to completion while new requests wait).
Sampling semantics, streaming, stop/bad words, trie constraints, and the
response schema are identical on both paths; beam search and prompt-learning
requests fall back to the static path automatically.
"""
from __future__ import annotations

import json
import logging
import random
import time
import traceback
from typing import Callable, List, Optional

from .detok import TokenStreamDecoder, trim_garbage
from .generate import generate, init_engine_and_tokenizer
from .trie import optional_last_token_ids

logger = logging.getLogger(__name__)


def get_data_package(request_dict: dict, default_random_seed: int) -> dict:
    """Per-prompt parameter gathering with reference defaults
    (codefuse_example.py:779-812)."""
    prompt_dicts = request_dict["prompts"]

    def gather(key, default=None):
        if default is None and all(key not in p for p in prompt_dicts):
            return None
        if default is None and any(key not in p for p in prompt_dicts):
            raise RuntimeError(
                f"request field '{key}' has no default and some prompts omit it"
            )
        return [p.get(key, default) for p in prompt_dicts]

    texts = []
    for p in prompt_dicts:
        assert isinstance(p["prompt"], str)
        texts.append(p["prompt"])

    return {
        "texts": texts,
        "output_len": request_dict["out_seq_length"],
        "beam_width": request_dict.get("beam_width", 1),
        "stop_words_list": gather("stop_words"),
        "bad_words_list": gather("bad_words"),
        "last_token_list": gather("last_token"),
        "top_k": gather("top_k", 50),
        "top_p": gather("top_p", 0.0),
        "beam_search_diversity_rate": gather("beam_search_diversity_rate", 0.0),
        "temperature": gather("temperature", 1.0),
        "len_penalty": gather("len_penalty", 0.0),
        "repetition_penalty": gather("repetition_penalty", 1.0),
        # engine-supported superset of the reference's request schema
        # (codefuse_example.py:779-812 stops at repetition_penalty): the
        # BaseSamplingLayer penalty set the reference exposes only at the op
        # level (presence_penalty, min_length) plus per-prompt bad_words
        "presence_penalty": gather("presence_penalty", 0.0),
        "min_length": gather("min_length", 0),
        "random_seed": gather("random_seed", default_random_seed),
        "output_log_probs": bool(request_dict.get("output_log_probs", False)),
        # request-level admission priority for the pooled path (lower admits
        # first; ignored on the static path, which has no queue)
        "priority": int(request_dict.get("priority", 0)),
    }


class CodeFuseHandler:
    """predict(request_dict, trace_id) -> (resultCode, errorMessage, resultMap)."""

    def __init__(
        self,
        ckpt_path: str = None,
        tokenizer_path: str = None,
        int8_mode: int = 0,
        tensor_parallel: int = 1,
        dtype: str = "bf16",
        end_id: Optional[int] = None,
        on_stream_text: Optional[Callable[[int, int, str], None]] = None,
        engine=None,
        tokenizer=None,
        trie=None,
        warmup: bool = True,
        weight_bits: int = 8,
        group_size: int = 0,
        kv_cache_dtype: Optional[str] = None,
        quantize_embeddings: Optional[bool] = None,
        pool: Optional[dict] = None,
    ):
        """Pass ckpt/tokenizer paths (production) or prebuilt engine/tokenizer/
        trie (tests). ``on_stream_text(batch_idx, beam_idx, text)`` taps
        streamed chunks; default prints batch 0 to stdout like the reference.

        ``pool``: kwargs for engine.server.BatchingServer (e.g.
        ``dict(max_slots=8, max_seq_len=2048)``) — enables continuous-batching
        serving. ``dict(speculative=True, spec_k=8, ...)`` builds a
        speculative-serving pool (engine/spec_pool.py): greedy requests
        flagged ``speculative`` ride (k+1)-wide verify ticks, everything
        else uses the static path. Requests too long for the pool and
        requests the pool class cannot serve transparently use the static
        path."""
        if engine is None:
            engine, tokenizer, trie = init_engine_and_tokenizer(
                ckpt_path,
                tokenizer_path,
                tensor_parallel=tensor_parallel,
                int8_mode=int8_mode,
                dtype=dtype,
                trie_needed=True,
                end_id=end_id,
                weight_bits=weight_bits,
                group_size=group_size,
                kv_cache_dtype=kv_cache_dtype,
                quantize_embeddings=quantize_embeddings,
            )
        self.engine = engine
        self.tokenizer = tokenizer
        self.trie = trie
        self.on_stream_text = on_stream_text
        self.server = None
        if pool is not None:
            from ..engine.server import BatchingServer, MultiPoolServer

            def with_defaults(kw):
                kw = dict(kw)
                # the response schema always carries cum_log_prob, so the pool
                # must track per-token log-probs (return_cum_log_probs)
                kw.setdefault("return_log_probs", True)
                # serving default: overlap the device→host sync with the next
                # tick's compute (engine/batcher.py pipeline_ticks). Streaming emissions
                # lag one tick (~tens of ms); pass pipeline_ticks=False to
                # serialize.
                kw.setdefault("pipeline_ticks", True)
                # trie extension lists (optional_last_tokens) can span
                # hundreds of vocab entries; give the pool room
                kw.setdefault("optional_last_width", 512)
                kw.setdefault("stop_words_width", 64)
                kw.setdefault("bad_words_width", 64)
                return kw

            if isinstance(pool, (list, tuple)):
                # length-classed pools: each request routes to the smallest
                # class it fits (engine/server.MultiPoolServer)
                self.server = MultiPoolServer(
                    engine, [with_defaults(kw) for kw in pool]
                )
            else:
                self.server = BatchingServer(engine, **with_defaults(pool))
        # the static generate() path shares ONE engine and is not reentrant
        # (two concurrent 13B static batches would double HBM transients);
        # concurrent non-pool-routable predict() calls serialize on this
        import threading as _threading

        self._static_lock = _threading.Lock()
        if warmup:
            generate(self.engine, self.tokenizer, ["demo"], 2, 1)
            if self.server is not None:
                from ..engine.server import MultiPoolServer as _MPS

                if isinstance(self.server, _MPS):
                    # warm EVERY pool class: routing by length means a tiny
                    # demo request would only compile the smallest class and
                    # the first long request would pay the full trace+compile
                    for srv in self.server.servers:
                        srv.generate(self.tokenizer.encode("demo"), 2)
                else:
                    self.server.generate(self.tokenizer.encode("demo"), 2)

    def _default_stream_sink(self, batch_idx: int, beam_idx: int, text: str):
        if batch_idx == 0 and beam_idx == 0:
            print(text, end="", flush=True)

    # ------------------------------------------------------------- pooled ----
    def _spec_pool_routable(self, dp: dict, prompts: List[List[int]]) -> bool:
        """Whether a speculative-flagged request can ride a speculative pool
        (handler built with pool=dict(speculative=True, ...)): greedy-only,
        processor-free, and within the pool's draft margin."""
        from ..engine.spec_pool import SpecPool

        b = getattr(self.server, "batcher", None)
        if not isinstance(b, SpecPool) or dp["beam_width"] != 1:
            return False
        margin = b.max_seq_len - (b.k + 2)
        n = len(prompts)
        for i, ids in enumerate(prompts):
            if len(ids) == 0 or len(ids) + dp["output_len"] > margin:
                return False
            if (dp["top_k"] or [50] * n)[i] != 1:
                return False
        for key, default in (
            ("temperature", 1.0), ("repetition_penalty", 1.0),
            ("presence_penalty", 0.0), ("min_length", 0), ("top_p", 0.0),
        ):
            v = dp.get(key)
            if v is not None and any(x != default for x in v):
                return False
        for key in ("stop_words_list", "bad_words_list", "last_token_list"):
            v = dp.get(key)
            if v is not None and any(v):
                return False
        return True

    def _pool_routable(self, data_package: dict, prompts: List[List[int]]) -> bool:
        """Whether every prompt of this request can ride the slot pool."""
        from ..engine.spec_pool import SpecPool

        if isinstance(getattr(self.server, "batcher", None), SpecPool):
            # spec pools serve only speculative-flagged requests, routed
            # before this check (predict's _spec_pool_routable branch)
            return False
        bw = data_package["beam_width"]
        out_len = data_package["output_len"]
        routable = getattr(self.server, "routable_pool", None)
        if bw != 1 and data_package.get("_stream"):
            # streamed beams ride the static path: its per-step callback
            # carries EVERY beam's newest token (pybind_callback semantics);
            # the pool streams only the best-so-far row
            return False
        if bw != 1 and data_package.get("output_log_probs"):
            # per-step beam log-probs ride the static path's reorder-tracked
            # buffer (sampling/beam.py step_log_probs); the beam pool tracks
            # scores only
            return False

        def wl_len(lists, i):
            if lists is None or not lists[i]:
                return 0
            return sum(len(self.tokenizer.encode(w)) for w in lists[i])

        for b, ids in enumerate(prompts):
            if len(ids) == 0:
                return False
            # validate each prompt against the pool it would actually route
            # to — MultiPoolServer routes PER PROMPT by length, and classes
            # may carry different caps/widths
            pool = (
                routable(len(ids) + out_len, bw)
                if routable is not None
                else (self.server.batcher if bw == 1 else None)
            )
            if pool is None or len(ids) + out_len > pool.max_seq_len:
                return False
            if bw == 1:
                tk = (data_package["top_k"] or [50])[b]
                if not (1 <= tk <= pool.sampling_cap):
                    # top_k=0 (pure top-p) needs the full sort
                    return False
            # word-list / trie-expansion widths beyond the pool's static
            # buffers fall back to the static path (make_request would
            # reject them client-side; never let an assert reach the
            # driver thread)
            if wl_len(data_package.get("stop_words_list"), b) > pool.stop_words_width:
                return False
            if wl_len(data_package.get("bad_words_list"), b) > pool.bad_words_width:
                return False
            lt = data_package.get("last_token_list")
            if lt is not None and lt[b] and self.trie is not None:
                olt = optional_last_token_ids(
                    self.trie, lt[b], self.engine.config.end_id
                )
                if len(olt) > pool.optional_last_width:
                    return False
        return True

    def _predict_pooled(self, dp: dict, use_callback: bool, prompts: List[List[int]]):
        """Route one request's prompts through the continuous-batching pool.
        Same sampling semantics/processor order as the static path (the pool's
        step fn mirrors _sample_and_advance) and the same response schema."""
        tok = self.tokenizer
        end_id = self.engine.config.end_id
        B = len(prompts)
        sink = self.on_stream_text or self._default_stream_sink

        def pick(key, default, b):
            v = dp.get(key)
            return default if v is None else v[b]

        def word_ids(lists, b):
            if lists is None or not lists[b]:
                return None
            return [list(tok.encode(w)) for w in lists[b]]

        bw = dp["beam_width"]
        start = time.time()
        uids = []
        for b in range(B):
            olt = None
            lt = dp.get("last_token_list")
            if lt is not None and lt[b]:
                assert self.trie is not None, "trie is None, can't select last token"
                olt = optional_last_token_ids(self.trie, lt[b], end_id)
            kw = dict(
                temperature=float(pick("temperature", 1.0, b)),
                repetition_penalty=float(pick("repetition_penalty", 1.0, b)),
                min_length=int(pick("min_length", 0, b)),
                priority=dp.get("priority", 0),
                stop_words=word_ids(dp.get("stop_words_list"), b),
                bad_words=word_ids(dp.get("bad_words_list"), b),
                optional_last_tokens=olt,
            )
            if bw == 1:
                kw.update(
                    top_k=int(pick("top_k", 50, b)),
                    top_p=float(pick("top_p", 0.0, b)),
                    presence_penalty=float(pick("presence_penalty", 0.0, b)),
                    random_seed=int(pick("random_seed", 0, b)),
                    on_text=(
                        (lambda s, b=b: sink(b, 0, s)) if use_callback else None
                    ),
                    tokenizer=tok if use_callback else None,
                )
            else:
                # beam requests route to a beam pool class of the same width
                # (engine/beam_pool.py); beam search ignores top_k/top_p/
                # presence/seed — DynamicDecodeLayer.cc:309-409 routing
                kw.update(
                    beam_width=bw,
                    beam_search_diversity_rate=float(
                        pick("beam_search_diversity_rate", 0.0, b)
                    ),
                    len_penalty=float(pick("len_penalty", 0.0, b)),
                )
            uids.append(self.server.submit(prompts[b], dp["output_len"], **kw))
        results = [self.server.wait(u) for u in uids]
        latency = time.time() - start

        def decode_gen(ids, in_len):
            gen = []
            for t in ids[in_len:]:
                if t == end_id:
                    break
                gen.append(int(t))
            return gen

        generated_code, lengths, cum_lps, step_lps = [], [], [], []
        for b, r in enumerate(results):
            if bw != 1:
                gens = [decode_gen(ids, len(prompts[b])) for ids in r.beam_output_ids]
                generated_code.append([trim_garbage(tok.decode(g)) for g in gens])
                lengths.append([len(g) for g in gens])
                cum_lps.append(list(r.beam_cum_log_probs))
                step_lps.append([[0.0] * dp["output_len"]] * bw)
                continue
            gen = decode_gen(r.output_ids, len(prompts[b]))
            generated_code.append([trim_garbage(tok.decode(gen))])
            lengths.append([len(gen)])
            cum_lps.append([r.cum_log_prob])
            lp = list(r.step_log_probs or [])
            step_lps.append([lp + [0.0] * (dp["output_len"] - len(lp))])

        response = {
            "latency": latency,
            "random_seed": dp["random_seed"],
            "generated_code": generated_code,
            "length": lengths,
            "cum_log_prob": cum_lps,
        }
        if dp["output_log_probs"]:
            response["output_log_probs"] = step_lps
        return response

    def _spec_eligible(self, request_dict, dp, prompts, use_callback) -> bool:
        """Prompt-lookup speculative decoding (engine/speculative.py) serves
        greedy non-streaming requests (any batch size — multi-prompt goes
        through the batched loop) with no token processors — the regime
        where multi-token steps pay off (repetitive code output)."""
        if not request_dict.get("speculative"):
            return False
        if use_callback or dp["beam_width"] != 1 or len(prompts) == 0:
            return False
        if any(v != 1 for v in (dp["top_k"] or [50] * len(prompts))):
            return False
        if dp["output_log_probs"]:
            return False
        for key in ("stop_words_list", "bad_words_list", "last_token_list"):
            v = dp.get(key)
            if v is not None and any(v):
                return False
        return all(len(p) > 0 for p in prompts)

    def _predict_speculative(self, dp: dict, prompts: List[List[int]]):
        from ..engine.speculative import (
            speculative_generate,
            speculative_generate_batched,
        )

        start = time.time()
        with self._static_lock:  # shares the engine's one-shot resources
            if len(prompts) == 1:
                toks, stats = speculative_generate(
                    self.engine, prompts[0], dp["output_len"]
                )
                all_toks, all_stats = [toks], [stats]
            else:
                all_toks, all_stats = speculative_generate_batched(
                    self.engine, prompts, dp["output_len"]
                )
        end_id = self.engine.config.end_id
        codes, lengths, lps = [], [], []
        for prompt, toks in zip(prompts, all_toks):
            gen = []
            for t in toks[len(prompt):]:
                if t == end_id:
                    break
                gen.append(int(t))
            codes.append([trim_garbage(self.tokenizer.decode(gen))])
            lengths.append([len(gen)])
        return {
            "latency": time.time() - start,
            "random_seed": dp["random_seed"],
            "generated_code": codes,
            "length": lengths,
            "cum_log_prob": [[s.cum_log_prob] for s in all_stats],
            "speculative": {
                "iterations": all_stats[0].iterations,
                "tokens_per_step": sum(
                    s.tokens_per_step for s in all_stats
                ) / len(all_stats),
                "accepted": sum(s.accepted for s in all_stats),
            },
        }

    def predict(self, request_dict: dict, trace_id: str):
        logger.info("%s request: %s", trace_id, json.dumps(request_dict, ensure_ascii=False))
        try:
            default_random_seed = random.randint(0, 1048576)
            use_callback = bool(request_dict.get("stream"))
            data_package = get_data_package(request_dict, default_random_seed)

            batch_size = len(data_package["texts"])
            beam_width = data_package["beam_width"]
            random_seed = data_package["random_seed"]

            # the static generate() path re-encodes internally; only tokenize
            # here for the routes that need token ids up front
            if request_dict.get("speculative") or self.server is not None:
                prompts_maybe = [
                    list(self.tokenizer.encode(t))
                    for t in data_package["texts"]
                ]
            if request_dict.get("speculative") and self.server is not None \
                    and self._spec_pool_routable(data_package, prompts_maybe):
                # continuous-batching speculative serving (engine/spec_pool):
                # rides the standard pooled path — streaming included
                data_package["_stream"] = use_callback
                response = self._predict_pooled(
                    data_package, use_callback, prompts_maybe
                )
                response_str = json.dumps(response, ensure_ascii=False)
                logger.info(
                    "%s response (pooled speculative): %s", trace_id,
                    response_str,
                )
                return (0, "ok", {"res": response_str})
            if request_dict.get("speculative") and self._spec_eligible(
                request_dict, data_package, prompts_maybe, use_callback
            ):
                response = self._predict_speculative(data_package, prompts_maybe)
                response_str = json.dumps(response, ensure_ascii=False)
                logger.info("%s response (speculative): %s", trace_id, response_str)
                return (0, "ok", {"res": response_str})

            if self.server is not None:
                prompts = prompts_maybe
                data_package["_stream"] = use_callback
                if self._pool_routable(data_package, prompts):
                    response = self._predict_pooled(
                        data_package, use_callback, prompts
                    )
                    response_str = json.dumps(response, ensure_ascii=False)
                    logger.info("%s response (pooled): %s", trace_id, response_str)
                    return (0, "ok", {"res": response_str})
                logger.info("%s not pool-routable; using the static path", trace_id)

            callback = None
            decoders: List[List[TokenStreamDecoder]] = []
            if use_callback:
                sink = self.on_stream_text or self._default_stream_sink
                decoders = [
                    [
                        TokenStreamDecoder(
                            self.engine.config.end_id,
                            self.tokenizer,
                            on_text=(lambda s, b=b, j=j: sink(b, j, s)),
                        )
                        for j in range(beam_width)
                    ]
                    for b in range(batch_size)
                ]

                def callback(message_dict: dict):
                    try:
                        last_tokens = message_dict["last_tokens"]
                        for b in range(batch_size):
                            for j in range(beam_width):
                                decoders[b][j].append_token(last_tokens[b][j])
                    except BaseException as err:  # noqa: BLE001 — parity with reference
                        logger.error("callback error: %s", err)

            data_package.pop("priority", None)  # pooled-path-only knob
            data_package.pop("_stream", None)
            want_step_lp = data_package["output_log_probs"]
            with self._static_lock:  # static path is not reentrant (see init)
                res = generate(
                    self.engine,
                    self.tokenizer,
                    trie=self.trie,
                    callback=callback,
                    **data_package,
                )
            result, lengths, cum_log_probs, latency = res[:4]
            step_log_probs = res[4] if want_step_lp else None

            if use_callback:
                for b in range(batch_size):
                    for j in range(beam_width):
                        decoders[b][j].append_token(self.engine.config.end_id)

            response = {
                "latency": latency,
                "random_seed": random_seed,
                "generated_code": result,
                "length": lengths,
                "cum_log_prob": cum_log_probs,
            }
            if want_step_lp:
                response["output_log_probs"] = step_log_probs
            response_str = json.dumps(response, ensure_ascii=False)
            logger.info("%s response: %s", trace_id, response_str)
            return (0, "ok", {"res": response_str})
        except BaseException:  # noqa: BLE001 — parity with reference handler
            return (1, traceback.format_exc(), {"res": ""})
