"""IVF index build CLI.

No reference counterpart (the reference builds graphs only) — the IVF
index is extra surface for corpora past one device's f32 memory
(BASELINE.md 50M table). Builds k-means cluster blocks from an .fbin
corpus and persists the index (`IVFIndex.save`); serve it with
`msann-search-ivf`.
"""

from __future__ import annotations

import argparse
import sys
import time

from mysteryann_tpu.cli.common import load_vectors
from mysteryann_tpu.ivf import IVFIndex
from mysteryann_tpu.utils.cache import enable_compile_cache


def main(argv=None) -> int:
    enable_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_type", default="float", choices=["float"])
    p.add_argument("--dist", default="ip", choices=["l2", "ip", "cosine"])
    p.add_argument("--base_data_path", required=True)
    p.add_argument("--index_save_path", required=True,
                   help="output .npz (IVFIndex.save container)")
    p.add_argument("--n_clusters", type=int, default=0,
                   help="0 = auto (2*sqrt(N))")
    p.add_argument("--cap_factor", type=float, default=1.6)
    p.add_argument("--kmeans_iters", type=int, default=10)
    p.add_argument("--store", default="f32", choices=["f32", "int8"],
                   help="int8 = global-scale quantized blocks (IP/cosine)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_threads", type=int, default=0,
                   help="accepted for reference compatibility; unused")
    args = p.parse_args(argv)

    base = load_vectors(args.base_data_path)
    t0 = time.time()
    idx = IVFIndex(base, metric=args.dist, n_clusters=args.n_clusters,
                   cap_factor=args.cap_factor,
                   kmeans_iters=args.kmeans_iters, seed=args.seed,
                   store=args.store, verbose=True)
    print(f"built {idx.n_clusters} clusters (cap {idx.cap}, "
          f"store {args.store}) in {time.time() - t0:.1f}s",
          file=sys.stderr, flush=True)
    idx.save(args.index_save_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
