"""Model and runtime configuration.

A re-design of the reference's three config tiers
(/root/reference/examples/pytorch/codefuse/huggingface_convert.py:107-122 writes
``config.ini``; /root/reference/examples/pytorch/codefuse/codefuse_example.py:621-632
reads it).  We keep the on-disk ``config.ini`` format byte-compatible so checkpoints
converted for the reference engine carry over, and add a typed dataclass layer on top.
"""
from __future__ import annotations

import dataclasses
import os
from configparser import ConfigParser
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GptNeoXConfig:
    """Architecture hyper-parameters of a GPT-NeoX family model.

    Mirrors the fields of the reference ``config.ini`` `[gptneox]` section plus the
    numerically-relevant constants the reference hardcodes (layernorm eps, rotary
    base: see /root/reference/src/fastertransformer/models/gptneox/GptNeoX.cc
    layernorm_eps_ = 1e-5, rotary base 10000 in
    kernels/decoder_masked_multihead_attention_utils.h).
    """

    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    rotary_embedding_dim: int
    start_id: int
    end_id: int
    inter_size: Optional[int] = None  # defaults to 4*hidden
    use_gptj_residual: bool = True
    layernorm_eps: float = 1e-5
    rotary_base: float = 10000.0
    activation: str = "gelu"  # "gelu" (exact, HF default) | "gelu-tanh" (FT's kernel) | "relu" | "silu"
    rotary_style: str = "neox"  # "neox" half-split | "gptj" interleaved pairs
    model_name: str = "gptneox"
    weight_data_type: str = "fp32"
    # --- LLaMA-family knobs (defaults = GPT-NeoX behavior) ---
    norm: str = "layernorm"  # | "rmsnorm" (no mean subtraction, no bias)
    gated_ffn: bool = False  # SwiGLU: h = act(x@gate) * (x@up), extra gate_w
    kv_head_num: Optional[int] = None  # GQA: KV heads < query heads (None = MHA)
    use_bias: bool = True  # False: bias-less qkv/proj/up/down (LLaMA)
    qkv_bias: bool = False  # bias on the fused QKV ONLY, even when
    # use_bias=False — the Qwen2 family's layout (q/k/v Linears carry bias,
    # o_proj and the MLP do not)
    # --- Mixture-of-Experts (Mixtral family) ---
    moe_experts: int = 0  # 0 = dense FFN; >0 = MoE with this many experts
    moe_top_k: int = 2  # experts per token
    # inference capacity factor: each expert's bucket holds
    # ceil(T * top_k / E * factor) tokens per call; overflow tokens drop
    # that expert's contribution (renormalized over survivors). 2.0 keeps
    # drops negligible at the batch sizes served here.
    moe_capacity_factor: float = 2.0
    position_embedding: str = "rope"  # | "learned": additive absolute
    # position table (params["pos_embed"] [max_pos, H]) instead of rotary —
    # the GPT-2/OPT lineage the reference serves via its multi_gpu_gpt
    # family (src/fastertransformer/models/multi_gpu_gpt). Learned-position
    # configs set rotary_embedding_dim=0 (apply_rotary no-ops).
    qkv_layout: str = "interleaved"  # fused-QKV column order: "interleaved"
    # (head, qkv, dh — HF GPT-NeoX native) | "concat" ([q all | k all | v all],
    # the only layout possible under GQA where q and kv head counts differ)

    def __post_init__(self):
        if self.inter_size is None:
            object.__setattr__(self, "inter_size", 4 * self.hidden_size)
        if self.kv_head_num is not None and self.kv_head_num != self.head_num:
            assert self.qkv_layout == "concat", "GQA requires qkv_layout='concat'"
            assert self.head_num % self.kv_head_num == 0

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head

    @property
    def num_heads(self) -> int:
        return self.head_num

    @property
    def kv_heads(self) -> int:
        return self.kv_head_num if self.kv_head_num is not None else self.head_num

    @property
    def qkv_cols(self) -> int:
        """Total fused-QKV output width: (nH + 2*nKV) * dh."""
        return (self.head_num + 2 * self.kv_heads) * self.size_per_head

    @property
    def head_dim(self) -> int:
        return self.size_per_head

    # ------------------------------------------------------------------ io ---
    @classmethod
    def from_ini(cls, path: str, section: str = "gptneox") -> "GptNeoXConfig":
        """Read a reference-format ``config.ini`` (possibly inside a ckpt dir)."""
        if os.path.isdir(path):
            path = os.path.join(path, "config.ini")
        cfg = ConfigParser()
        read = cfg.read(path)
        if not read:
            raise FileNotFoundError(f"config.ini not found at {path}")
        sec = cfg[section]
        return cls(
            head_num=int(sec["head_num"]),
            size_per_head=int(sec["size_per_head"]),
            inter_size=int(sec["inter_size"]) if "inter_size" in sec else None,
            layer_num=int(sec["num_layer"]),
            rotary_embedding_dim=int(sec["rotary_embedding"]),
            vocab_size=int(sec["vocab_size"]),
            start_id=int(sec["start_id"]),
            end_id=int(sec["end_id"]),
            use_gptj_residual=sec.get("use_gptj_residual", "1") == "1",
            model_name=sec.get("model_name", "gptneox"),
            weight_data_type=sec.get("weight_data_type", "fp32"),
            layernorm_eps=float(sec.get("layernorm_eps", "1e-5")),
            rotary_base=float(sec.get("rotary_base", "10000.0")),
            rotary_style=sec.get("rotary_style", "neox"),
            activation=sec.get("activation", "gelu"),
            norm=sec.get("norm", "layernorm"),
            gated_ffn=sec.get("gated_ffn", "0") == "1",
            kv_head_num=int(sec["kv_head_num"]) if "kv_head_num" in sec else None,
            use_bias=sec.get("use_bias", "1") == "1",
            qkv_bias=sec.get("qkv_bias", "0") == "1",
            position_embedding=sec.get("position_embedding", "rope"),
            moe_experts=int(sec.get("moe_experts", "0")),
            moe_top_k=int(sec.get("moe_top_k", "2")),
            moe_capacity_factor=float(sec.get("moe_capacity_factor", "2.0")),
            qkv_layout=sec.get("qkv_layout", "interleaved"),
        )

    def to_ini(self, path: str, section: str = "gptneox") -> None:
        if os.path.isdir(path):
            path = os.path.join(path, "config.ini")
        cfg = ConfigParser()
        cfg[section] = {
            "model_name": self.model_name,
            "head_num": str(self.head_num),
            "size_per_head": str(self.size_per_head),
            "inter_size": str(self.inter_size),
            "num_layer": str(self.layer_num),
            "rotary_embedding": str(self.rotary_embedding_dim),
            "vocab_size": str(self.vocab_size),
            "start_id": str(self.start_id),
            "end_id": str(self.end_id),
            "use_gptj_residual": "1" if self.use_gptj_residual else "0",
            "weight_data_type": self.weight_data_type,
        }
        # Non-default architecture knobs are persisted so from_ini round-trips
        # exactly (a GPT-J config must come back with rotary_style="gptj", not
        # the neox default). Written only when non-default so a config.ini for
        # a reference-converted GPT-NeoX checkpoint stays byte-identical to
        # what huggingface_convert.py:107-122 emits.
        defaults = {
            "rotary_style": "neox",
            "activation": "gelu",
            "layernorm_eps": 1e-5,
            "rotary_base": 10000.0,
            "norm": "layernorm",
            "gated_ffn": False,
            "kv_head_num": None,
            "use_bias": True,
            "qkv_bias": False,
            "position_embedding": "rope",
            "moe_experts": 0,
            "moe_top_k": 2,
            "moe_capacity_factor": 2.0,
            "qkv_layout": "interleaved",
        }
        for key, default in defaults.items():
            value = getattr(self, key)
            if value != default:
                if isinstance(value, bool):
                    cfg[section][key] = "1" if value else "0"
                elif isinstance(value, float):
                    cfg[section][key] = repr(value)
                else:
                    cfg[section][key] = str(value)
        with open(path, "w") as f:
            cfg.write(f)

    # ----------------------------------------------------------- presets ---
    @classmethod
    def codefuse_13b(cls) -> "GptNeoXConfig":
        """CodeFuse-13B: the reference's flagship model (README.md:41).

        activation is the TANH-approx gelu: the reference engine hardcodes
        that formula in its FFN kernel (activation_kernels.cu:50-57
        GeluActivation), so serving CodeFuse through FasterTransformer always
        runs tanh-gelu regardless of the HF config's exact-erf "gelu". This
        preset matches the reference's serving numerics.
        Checkpoints converted from HF keep hidden_act verbatim instead
        (ckpt/convert.py) for HF-exact parity."""
        return cls(
            head_num=40,
            size_per_head=128,
            layer_num=40,
            vocab_size=100831,
            rotary_embedding_dim=128,
            inter_size=20480,
            start_id=100256,
            end_id=100256,
            use_gptj_residual=True,
            activation="gelu-tanh",
            model_name="codefuse-13b",
        )

    @classmethod
    def pythia_1_4b(cls) -> "GptNeoXConfig":
        return cls(
            head_num=16,
            size_per_head=128,
            layer_num=24,
            vocab_size=50304,
            rotary_embedding_dim=32,  # rotary_pct 0.25
            inter_size=8192,
            start_id=0,
            end_id=0,
            use_gptj_residual=True,
            model_name="pythia-1.4b",
        )

    @classmethod
    def tiny(cls, **overrides) -> "GptNeoXConfig":
        """A tiny config for unit tests."""
        kw = dict(
            head_num=4,
            size_per_head=16,
            layer_num=2,
            vocab_size=128,
            rotary_embedding_dim=4,  # rotary_pct 0.25
            inter_size=256,
            start_id=0,
            end_id=1,
            use_gptj_residual=True,
            model_name="tiny",
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Engine runtime knobs (the analog of the reference's env-var tier, SURVEY §5).

    Attributes:
      dtype: activation/weight compute dtype ("bf16"|"fp32"). The reference
        serves fp16; "fp16" is served as bf16 (core/dtypes.py).
      int8_mode: 0 = dense, 1 = weight-only int8 (per-output-channel symmetric
        scales), matching the reference's ``int8_mode`` values
        (/root/reference/src/fastertransformer/models/gptneox/GptNeoX.h int8_mode_).
      kv_cache_dtype: dtype for the KV cache.
      max_batch_size / max_seq_len: static upper bounds used to pre-allocate.
      seq_bucket: generation shapes are padded up to a multiple of this to bound
        the number of distinct compiled programs.
      use_flash_prefill: on the GPU, run prefill attention through cuDNN's
        fused attention (ops/attention.prefill_attention_fused) instead of
        the einsum path.
      use_flash_decode: on the GPU, run decode attention through the Triton
        decode kernel (ops/flash_decode.py), which reads only live cache
        bytes, instead of the XLA path over the whole slab.
      tensor_para_size: TP degree (mesh axis "tp").
      data_para_size: replica axis (mesh axis "dp").
      pipeline_para_size: PP stage count (mesh axis "pp"); layers and KV cache
        are split into contiguous blocks per stage (parallel/pipeline.py, the
        analog of the reference's pipeline_para_size_).
      logits_dtype: lm-head GEMM output dtype; the reference computes fp32 logits
        (GptNeoX.cc uses FT's gemm with float out for logits).
    """

    dtype: str = "bf16"
    int8_mode: int = 0
    # SmoothQuant W8A8: batch-wide GEMMs (prefill / chunked prefill) quantize
    # activations per token and run int8 x int8 dots against the int8
    # weights — the reference's int8_mode=2 semantics (its gptneox family
    # never wired it; SURVEY §2.2). Requires int8 per-channel weights
    # (int8_mode=1); prepare checkpoints with ckpt.smoothquant's fold for
    # best accuracy. Decode-width calls stay weight-only (weight-bound).
    act_int8: bool = False
    kv_cache_dtype: Optional[str] = None
    max_batch_size: int = 8
    max_seq_len: int = 2048
    seq_bucket: int = 128
    use_flash_prefill: bool = True
    use_flash_decode: bool = True
    tensor_para_size: int = 1
    data_para_size: int = 1
    pipeline_para_size: int = 1
    # PP microbatch count M (reference: GptNeoX.cc:780-788 getLocalBatchSize):
    # prefill pipelines M sequence chunks and decode M batch-row groups across
    # the pp stages, so in steady state all stages compute concurrently.
    # Requires padded input width % M == 0 (prefill) and batch % M == 0
    # (decode). M=1 = the serial capacity-only schedule. Decode at small
    # batch is weight-streaming-bound, where M>1 re-streams weights per
    # microbatch and LOSES — raise M for compute-bound regimes (prefill,
    # large batch) only.
    pp_microbatches: int = 1
    logits_dtype: str = "fp32"
    donate_cache: bool = True
    # Debug/verification mode — the analog of the reference's FT_DEBUG_LEVEL
    # forced-sync checking (utils/cuda_utils.h:129-154). "DEBUG" (or the
    # FT_DEBUG_LEVEL env var set to DEBUG) makes generate() first run a
    # checkified prefill + decode step with layer-attributed NaN/Inf checks
    # (utils/debug.py). Empty = off (zero overhead, checks compile away).
    debug_level: str = ""

    def debug_enabled(self) -> bool:
        import os

        lvl = self.debug_level or os.environ.get("FT_DEBUG_LEVEL", "")
        return lvl.upper() == "DEBUG"
