"""Shared inputs of the port's CPU parity tests (tests/test_torch_*.py):
narrow model widths, seeded inputs, flax variables moved away from
their initial BatchNorm values, and the JAX package's native library
loaded for real."""

import fcntl
import hashlib
import os
import tempfile
import time

import jax
import numpy as np
import pytest

from riders_tpu.io import native as jnative

# one block per stage, narrow widths (tests/test_convert_sml.py's plan)
TINY_STAGES = ((3, 1, 1, 8, 1), (3, 2, 6, 8, 1), (5, 2, 6, 12, 1),
               (3, 2, 6, 16, 1), (5, 1, 6, 16, 1), (5, 2, 6, 24, 1),
               (3, 1, 6, 24, 1))
TINY_TAPS = (1, 2, 4, 6)
NARROW_RCNET = dict(n_filters_encoder_image=(8, 16, 32, 32, 32),
                    n_neurons_encoder_depth=(8, 16, 32, 32, 32),
                    n_filters_decoder=(64, 32, 16, 8, 4),
                    attention_layers=1, attention_heads=4)


def perturbed(variables, rng):
    """numpy copy of flax variables with BN statistics and affine terms
    away from their 0 / 1 initial values, so folding and eps matter."""
    variables = jax.device_get(variables)

    def walk(tree, stats):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, stats)
            elif stats and key == "mean":
                tree[key] = (0.1 * rng.standard_normal(value.shape)
                             ).astype(np.float32)
            elif stats and key == "var":
                tree[key] = (0.5 + rng.random(value.shape)).astype(np.float32)
            elif key in ("scale", "bias"):
                tree[key] = (value + 0.1 * rng.standard_normal(value.shape)
                             ).astype(np.float32)
    walk(variables["params"], False)
    walk(variables.get("batch_stats", {}), True)
    return variables


def rcnet_inputs(rng, patch, B=2, K=4, H=40, W=56):
    """An edge-padded frame, integer-pixel points in padded coordinates,
    their boxes, and a mask with one dropped point per frame."""
    ph, pw = patch
    image = rng.random((B, H + 2 * (ph // 2), W + 2 * (pw // 2), 3)
                       ).astype(np.float32)
    u = rng.integers(0, W, (B, K)).astype(np.float32)
    v = rng.integers(0, H, (B, K)).astype(np.float32)
    z = (1 + 40 * rng.random((B, K))).astype(np.float32)
    pts = np.stack([u + pw // 2, v + ph // 2, z], -1)
    boxes = np.stack([u, v, u + 2 * (pw // 2), v + 2 * (ph // 2)], -1
                     ).astype(np.float32)
    mask = np.ones((B, K), np.float32)
    mask[:, -1] = 0.0
    return image, pts, boxes, mask


def jax_native_library(deadline_s=120.0):
    """The JAX package's native Delaunay library, loaded in this process,
    or the test fails saying why.

    On a fresh checkout `native/libriders_native.so` does not exist yet.
    The JAX loader builds it with `make` straight into place, and every
    process that imports tests/test_native.py calls that loader, so under
    several workers one process can open the file while another's linker
    is still writing it.  The loader remembers such a failure for the
    life of the process, and `delaunay_interpolate` then densifies with
    scipy without a word: a JAX side that is not the path
    `process_frame` takes.  Here, under an exclusive lock (one per
    library path, so the callers of this helper build one at a time), the
    remembered failure is cleared and the load retried until it succeeds
    or `deadline_s` (the JAX loader's own build timeout) has passed."""
    digest = hashlib.sha1(jnative._LIB_PATH.encode()).hexdigest()[:12]
    lock_path = os.path.join(tempfile.gettempdir(),
                             f"riders_native-{digest}.lock")
    deadline = time.monotonic() + deadline_s
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released as the file closes
        while True:
            lib = jnative.load()
            if lib is not None:
                return lib
            if time.monotonic() > deadline:
                break
            with jnative._lock:
                jnative._load_failed = False
            time.sleep(0.2)
    pytest.fail(f"the JAX package's native library ({jnative._LIB_PATH}) "
                f"did not load within {deadline_s:.0f} s")
