"""Flat (exact, brute-force) search CLI.

No reference counterpart — on an accelerator the exact scan is a serving
mode in its own right (see mysteryann_tpu/flat.py). Same report schema as the graph
search CLIs; recall should be ~1.0 by construction.
"""

from __future__ import annotations

import argparse

from mysteryann_tpu.cli.common import (
    add_common_search_flags,
    load_vectors,
    result_header,
    result_row,
    write_csv,
)
from mysteryann_tpu.flat import FlatIndex
from mysteryann_tpu.io import read_gt_with_dist
from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_search_flags(p)
    p.add_argument("--tile", type=int, default=None,
                   help="rows per score block (default: sized from "
                        "device memory)")
    p.add_argument("--oversample", type=int, default=2)
    p.add_argument("--precision", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="bf16: half-byte resident table + exact f32 "
                        "rerank; int8: "
                        "global-scale scan + exact f32 rerank")
    args = p.parse_args(argv)

    base = load_vectors(args.base_data_path)
    queries = load_vectors(args.query_path)
    gt_ids, gt_dists = read_gt_with_dist(args.gt_path)
    idx = FlatIndex(base, metric=args.dist or "ip", tile=args.tile,
                    oversample=args.oversample, precision=args.precision)
    r = idx.benchmark(queries, k=args.k, query_batch=args.query_batch)
    row = {
        "L_pq": 0,
        "qps": r["qps"],
        "avg_cmps": r["avg_cmps"],
        "avg_hops": 0.0,
        "mean_latency_ms": r["mean_latency_ms"],
        "recall": compute_recall(r["ids"], gt_ids, args.k),
        "rderr": compute_rderr(r["dists"], gt_dists, args.k,
                               args.dist or "ip"),
    }
    print(result_header())
    print(result_row(row))
    if args.csv_path:
        write_csv(args.csv_path, [row])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
