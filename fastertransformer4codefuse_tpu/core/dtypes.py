"""Dtype string <-> jnp dtype mapping.

The reference maps "fp16"/"fp32" strings to torch dtypes
(/root/reference/examples/pytorch/codefuse/codefuse_example.py:180). The engine
serves 16-bit models in bfloat16; "fp16" is accepted as an alias for bf16 so
reference configs keep working.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_STR2JNP = {
    "fp32": jnp.float32,
    "float32": jnp.float32,
    "fp16": jnp.bfloat16,  # alias: fp16 checkpoints are served as bf16
    "float16": jnp.bfloat16,
    "bf16": jnp.bfloat16,
    "bfloat16": jnp.bfloat16,
    "int8": jnp.int8,
}

_STR2NP = {
    "fp32": np.float32,
    "float32": np.float32,
    "fp16": np.float16,
    "float16": np.float16,
    "bf16": np.float32,  # numpy has no bf16; widen to fp32 on host
    "int8": np.int8,
}


def jnp_dtype(name):
    if not isinstance(name, str):
        return name
    try:
        return _STR2JNP[name]
    except KeyError:
        raise ValueError(f"unknown dtype string: {name!r}")


def np_dtype(name):
    if not isinstance(name, str):
        return name
    try:
        return _STR2NP[name]
    except KeyError:
        raise ValueError(f"unknown dtype string: {name!r}")
