"""Synthetic cross-modal dataset generator.

The reference validates only on downloaded datasets (prepare_data.sh) —
it has no synthetic fixture. We need one for unit tests and benchmarks:
an out-of-distribution (OOD) query workload resembling text→image retrieval,
where training/search queries come from a *different* distribution than the
base set (the regime RoarGraph targets).

Construction: points live on a low-intrinsic-dimension manifold (real CLIP
embeddings have intrinsic dim of a few dozen — a flat isotropic cloud in
128-d makes top-k near-ties that no graph method can rank, which is not
the workload the reference targets). Latent samples are concept-mixture
Gaussians in ``intrinsic_dim``; the base ("image") modality and the query
("text") modality map that latent space to the ambient dimension through
*different* random linear maps plus a shared-direction offset. Queries are
thus OOD w.r.t. the base cloud (the RoarGraph setting) while their true
neighbors remain semantically meaningful.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_cross_modal(
    n_base: int,
    n_query: int,
    dim: int,
    n_concepts: int = 256,
    intrinsic_dim: int = 16,
    modality_gap: float = 0.35,
    noise: float = 0.45,
    metric: str = "ip",
    seed: int = 0,
    query_seed: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (base [n_base, dim], queries [n_query, dim]) float32.

    ``query_seed`` draws the query-side samples from an independent RNG
    stream while keeping the WORLD (concepts, modality maps, gap) from
    ``seed`` — the way to get held-out eval queries from the same
    distribution as a train set generated with plain ``seed`` (two
    different ``seed`` values are two unrelated worlds: eval queries
    from one share no latent structure with a base from the other).
    Default ``None`` keeps the original single-stream draws.
    """
    rng = np.random.default_rng(seed)
    h = min(intrinsic_dim, dim)
    concepts = rng.standard_normal((n_concepts, h)).astype(np.float32)

    # modality maps: image map A, text map = A blended with a rotation
    a_map = rng.standard_normal((h, dim)).astype(np.float32) / np.sqrt(h)
    r_mix = rng.standard_normal((h, h)).astype(np.float32) / np.sqrt(h)
    b_map = ((1.0 - modality_gap) * a_map
             + modality_gap * (r_mix @ a_map)).astype(np.float32)
    gap_dir = rng.standard_normal((1, dim)).astype(np.float32)
    gap_dir /= np.linalg.norm(gap_dir)

    # power-law concept popularity (real corpora are Zipfian)
    pop = 1.0 / np.arange(1, n_concepts + 1) ** 0.8
    pop /= pop.sum()

    def sample(n: int, query_side: bool, rng=rng) -> np.ndarray:
        ids = rng.choice(n_concepts, size=n, p=pop)
        z = concepts[ids] + rng.standard_normal((n, h)).astype(np.float32) * noise
        x = z @ (b_map if query_side else a_map)
        if query_side:
            x = x + gap_dir * (modality_gap * 2.0)
        # small ambient noise so points are not exactly on the manifold
        x = x + rng.standard_normal((n, dim)).astype(np.float32) * 0.02
        if metric in ("cosine", "ip"):
            # embeddings in these workloads are ~unit-norm (CLIP-style)
            x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        return x.astype(np.float32)

    base = sample(n_base, False)
    qrng = rng if query_seed is None else np.random.default_rng(query_seed)
    return base, sample(n_query, True, rng=qrng)


# ---------------------------------------------------------------------------
# Device-side generator: the corpus as a FUNCTION of the row index.
#
# For corpora too large to hold in f32 next to the index, neither the
# host copy plus its host->device upload nor a resident f32 copy is
# viable. This generator derives every row from a counter-based
# PRNG key (`fold_in(key, row_index)`), so any subset of rows can be
# (re)generated on device, in any order, bit-identically:
#   - tile streaming builds exact GT / int8 tables without a host copy;
#   - "gather f32 rows" for reranking becomes regeneration from ids — a few
#     threefry blocks + one small matmul instead of an impossible fetch.
# Distribution matches make_cross_modal's design (concept-mixture manifold,
# Zipf popularity, modality-gapped query map); the draws differ (threefry vs
# PCG64), so it is a sibling dataset family, not a bit-identical twin.
# ---------------------------------------------------------------------------


class CrossModalDeviceSpec:
    """Tiny constant arrays + keys defining a deterministic corpus."""

    def __init__(self, dim: int, n_concepts: int = 256,
                 intrinsic_dim: int = 16, modality_gap: float = 0.35,
                 noise: float = 0.45, metric: str = "ip", seed: int = 0):
        import jax.numpy as jnp

        rng = np.random.default_rng(seed)
        h = min(intrinsic_dim, dim)
        concepts = rng.standard_normal((n_concepts, h)).astype(np.float32)
        a_map = rng.standard_normal((h, dim)).astype(np.float32) / np.sqrt(h)
        r_mix = rng.standard_normal((h, h)).astype(np.float32) / np.sqrt(h)
        b_map = ((1.0 - modality_gap) * a_map
                 + modality_gap * (r_mix @ a_map)).astype(np.float32)
        gap_dir = rng.standard_normal((1, dim)).astype(np.float32)
        gap_dir /= np.linalg.norm(gap_dir)
        pop = 1.0 / np.arange(1, n_concepts + 1) ** 0.8
        cdf = np.cumsum(pop / pop.sum()).astype(np.float32)

        self.dim, self.h = dim, h
        self.n_concepts = n_concepts
        self.noise = float(noise)
        self.modality_gap = float(modality_gap)
        self.normalize = metric in ("ip", "cosine")
        self.concepts = jnp.asarray(concepts)
        self.a_map = jnp.asarray(a_map)
        self.b_map = jnp.asarray(b_map)
        self.gap_dir = jnp.asarray(gap_dir)
        self.pop_cdf = jnp.asarray(cdf)
        self.seed = seed

    def rows(self, idx, query_side: bool = False):
        """Generate rows for absolute indices ``idx`` (int32 [T]) -> f32
        [T, dim]. Same idx + same batch shape -> bit-identical rows; across
        different batch shapes XLA may re-tile the tiny projection matmul,
        so rows agree only to float reassociation (~1e-7 — irrelevant for
        distance work, but don't hash rows across differently-shaped
        calls)."""
        return _gen_rows(self.concepts, self.a_map, self.b_map,
                         self.gap_dir, self.pop_cdf, idx,
                         seed=self.seed, query_side=bool(query_side),
                         noise=self.noise, modality_gap=self.modality_gap,
                         normalize=self.normalize)

    def base_tile(self, start: int, size: int):
        import jax.numpy as jnp
        return self.rows(start + jnp.arange(size, dtype=jnp.int32))

    def queries(self, n: int):
        import jax.numpy as jnp
        return self.rows(jnp.arange(n, dtype=jnp.int32), query_side=True)


def _gen_rows(concepts, a_map, b_map, gap_dir, pop_cdf, idx, *, seed: int,
              query_side: bool, noise: float, modality_gap: float,
              normalize: bool):
    global _gen_rows_jit
    if _gen_rows_jit is None:  # lazy: keep module importable without jax
        _gen_rows_jit = _make_gen_rows_jit()
    return _gen_rows_jit(concepts, a_map, b_map, gap_dir, pop_cdf, idx,
                         seed=seed, query_side=query_side, noise=noise,
                         modality_gap=modality_gap, normalize=normalize)


def _make_gen_rows_jit():
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnames=("seed", "query_side", "noise",
                                       "modality_gap", "normalize"))
    def gen(concepts, a_map, b_map, gap_dir, pop_cdf, idx, *, seed: int,
            query_side: bool, noise: float, modality_gap: float,
            normalize: bool):
        nc, h = concepts.shape
        dim = a_map.shape[1]
        # separate streams per modality so base i and query i differ
        root = jax.random.fold_in(jax.random.PRNGKey(seed),
                                  1 if query_side else 0)
        keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(idx)
        u = jax.vmap(lambda k: jax.random.uniform(k, ()))(keys)
        eps = jax.vmap(
            lambda k: jax.random.normal(k, (h + dim,), jnp.float32))(
            jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys))
        cid = jnp.searchsorted(pop_cdf, u).astype(jnp.int32)
        cid = jnp.minimum(cid, nc - 1)
        # one-hot matmul instead of a row gather: the concept table is
        # tiny, so the contraction is cheap and gathers nothing
        onehot = (cid[:, None] ==
                  jnp.arange(nc, dtype=jnp.int32)[None, :]).astype(
            jnp.float32)
        z = onehot @ concepts + noise * eps[:, :h]
        x = z @ (b_map if query_side else a_map)
        if query_side:
            x = x + gap_dir * (modality_gap * 2.0)
        x = x + 0.02 * eps[:, h:]
        if normalize:
            x = x / jnp.maximum(
                jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        return x

    return gen


_gen_rows_jit = None
