"""viso_tpu — a JAX visual odometry / SLAM engine.

A JAX/XLA implementation of the full visual-odometry
pipeline the reference (Seasandwpy/viso) defines — feature detection,
pyramidal LK tracking, RANSAC two-view initialization, triangulation,
direct photometric tracking, sliding-window bundle adjustment — plus the
stereo, loop-closure, pose-graph, and distributed-BA capabilities of the
project north star.

Design principles:
  * Static shapes + validity masks everywhere (no dynamic resizing).
  * Structure-of-arrays state living in device memory; batched math.
  * `vmap`/`lax.scan` over per-feature loops; one jitted launch per
    frame-level step.
  * Multi-device scaling through `jax.sharding.Mesh` + `shard_map`,
    collectives between devices.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry / normal-equation matmuls are tiny but precision-critical:
# TF32 tensor-core products (the GPU's default for f32 matmuls) keep ~3
# decimal digits, ~1e-3 relative error on pose math. Force full-f32
# products; the frame-rate hot paths (window sampling, elementwise
# photometrics) are unaffected.
_jax.config.update("jax_default_matmul_precision", "float32")

from viso_tpu import geometry, ops, mapping, backend, parallel, data, slam, utils  # noqa: F401,E402
