"""Distance kernels — tiled matmuls.

Batched replacement for the reference's hand-written AVX-512 loops
(reference include/efanna2e/distance.h:39-225). The per-pair SIMD
`Distance::compare(a, b, dim)` becomes a *batched* primitive: a block of
query vectors against a block of candidate vectors is one `[B, d] @ [d, C]`
matmul — this is where ~all of the framework's FLOPs live, both at build
and at query time.

Conventions preserved from the reference:
- inner product is returned NEGATED so that smaller = better for every
  metric (reference distance.h:223);
- L2 is the *squared* euclidean distance (no sqrt — ordering-equivalent,
  reference distance.h:39-89);
- cosine = normalize once, then negated inner product
  (reference src/index.cpp:16-19 + src/index_bipartite.cpp:176-182).

Precision: matmuls run with ``preferred_element_type=float32``. For f32
operands on an H100, ``jax.lax.Precision.DEFAULT`` lets XLA multiply in
TF32 (10-bit mantissa, f32 accumulation) on the tensor cores — the fast
path, with ~1e-3 relative error per product. Pass ``precision="highest"``
for full f32 multiplication when the result must be exact (ground truth,
validation against numpy). On the CPU both are full f32.
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp


class Metric(enum.Enum):
    """Reference Metric enum {L2, INNER_PRODUCT, COSINE} (distance.h:15)."""

    L2 = "l2"
    IP = "ip"
    COSINE = "cosine"

    @classmethod
    def parse(cls, s: "Metric | str") -> "Metric":
        if isinstance(s, Metric):
            return s
        s = s.lower()
        for m in cls:
            if m.value == s:
                return m
        aliases = {"inner_product": cls.IP, "euclidean": cls.L2}
        if s in aliases:
            return aliases[s]
        raise ValueError(f"unknown metric {s!r}")


def normalize_rows(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Row-wise L2 normalization (reference util.h:215-237)."""
    n = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.maximum(n, eps)


def squared_norms(x: jax.Array) -> jax.Array:
    """||x_i||^2 per row — precomputable for the L2 expansion."""
    return jnp.sum(x * x, axis=-1)


@partial(jax.jit, static_argnames=("metric", "precision"))
def pairwise_dist(
    q: jax.Array,
    b: jax.Array,
    metric: Metric = Metric.IP,
    b_sqnorm: jax.Array | None = None,
    precision: str = "default",
) -> jax.Array:
    """All-pairs distances ``[Bq, Cb]`` between query block and base block.

    For COSINE the inputs are assumed pre-normalized (do it once at load,
    like the reference normalizes the dataset up front rather than inside
    the kernel — src/index_bipartite.cpp:176-182).
    """
    metric = Metric.parse(metric)
    prec = jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    ip = jax.lax.dot_general(
        q, b,
        dimension_numbers=(((q.ndim - 1,), (b.ndim - 1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=prec,
    )
    if metric in (Metric.IP, Metric.COSINE):
        return -ip
    # L2: ||q||^2 - 2 q.b + ||b||^2 ; ||q||^2 is rank-preserving per query but
    # kept so absolute values match the reference's squared-L2 outputs.
    qn = squared_norms(q)[..., None]
    bn = squared_norms(b) if b_sqnorm is None else b_sqnorm
    d = qn - 2.0 * ip + bn[None, :]
    return jnp.maximum(d, 0.0)


@partial(jax.jit, static_argnames=("metric", "precision"))
def point_dist(
    a: jax.Array,
    b: jax.Array,
    metric: Metric = Metric.IP,
    precision: str = "default",
) -> jax.Array:
    """Row-wise distance between aligned batches ``[B, d] x [B, d] -> [B]``."""
    metric = Metric.parse(metric)
    ip = jnp.sum(a * b, axis=-1)
    if metric in (Metric.IP, Metric.COSINE):
        return -ip
    diff_sq = squared_norms(a) - 2.0 * ip + squared_norms(b)
    return jnp.maximum(diff_sq, 0.0)


def prepare_vectors(x, metric: Metric | str):
    """Upload ``x`` as f32 and apply the metric's one-time preprocessing
    (cosine → normalize). Device arrays are used in place."""
    metric = Metric.parse(metric)
    x = jnp.asarray(x, dtype=jnp.float32)
    if metric == Metric.COSINE:
        x = normalize_rows(x)
    return x
