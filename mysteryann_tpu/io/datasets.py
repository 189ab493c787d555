"""Dataset registry + download/prepare pipeline.

Library counterpart of the reference's dataset plumbing
(reference prepare_data.sh:1-67, export_fbin_from_npy.py:1-42,
prepare_for_clip_webvid.py:1-140): the same three cross-modal corpora,
the same byte-range slicing trick for partial downloads of the Yandex
T2I files, the same npy-shard → fbin export for LAION, and the same
clip4clip-style frame pooling for WebVid — but as a library with a
registry, streaming (constant-memory) export, and size validation on
every artifact.

Downloads need network egress; in an air-gapped environment `prepare`
raises with the exact URLs so files can be staged out-of-band into
`data_dir` and the call re-run (it is idempotent — existing files with
the right size are kept).
"""

from __future__ import annotations

import dataclasses
import http.client
import os
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mysteryann_tpu.io.formats import _HEADER, read_gt_with_dist, read_meta


@dataclasses.dataclass(frozen=True)
class RemoteFile:
    url: str
    filename: str
    # byte-range download: keep only the first `head_points` rows of a
    # bigger remote fbin (reference prepare_data.sh:23-27 curl -r math)
    head_points: Optional[int] = None
    dim: Optional[int] = None

    def byte_range(self) -> Optional[int]:
        if self.head_points is None:
            return None
        assert self.dim is not None
        return 8 + 4 * self.dim * self.head_points


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    dim: int
    metric: str
    base_file: str           # local filename of the base fbin
    train_query_file: str    # sampled other-modality training queries
    eval_query_file: str
    gt_file: str
    remotes: Tuple[RemoteFile, ...]
    n_base: int = 0
    notes: str = ""


_T2I = "https://storage.yandexcloud.net/yandex-research/ann-datasets/T2I"
_ZEN = "https://zenodo.org/records/11073098/files"
_EYE = ("https://the-eye.eu/public/AI/cah/laion400m-met-release/"
        "laion400m-embeddings")

# LAION npy shard indices — shard 8 is absent upstream
# (reference prepare_data.sh:35, 42: `for i in 0 1 2 3 4 5 6 7 9 10`)
LAION_SHARDS = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)

REGISTRY: Dict[str, DatasetSpec] = {
    "t2i-10M": DatasetSpec(
        name="t2i-10M", dim=200, metric="ip", n_base=10_000_000,
        base_file="base.10M.fbin", train_query_file="query.train.10M.fbin",
        eval_query_file="query.10k.fbin", gt_file="gt.10k.ibin",
        remotes=(
            RemoteFile(f"{_T2I}/base.10M.fbin", "base.10M.fbin"),
            RemoteFile(f"{_T2I}/query.learn.50M.fbin",
                       "query.train.10M.fbin", head_points=10_000_000,
                       dim=200),
            RemoteFile(f"{_T2I}/query.public.100K.fbin", "query.10k.fbin",
                       head_points=10_000, dim=200),
            RemoteFile(f"{_ZEN}/t2i.gt.10k.ibin", "gt.10k.ibin"),
        ),
        notes="Yandex Text-to-Image: 200-d, inner product; queries are "
              "text embeddings (OOD vs the image base).",
    ),
    "laion-10M": DatasetSpec(
        name="laion-10M", dim=512, metric="ip", n_base=10_000_000,
        base_file="base.10M.fbin", train_query_file="query.train.10M.fbin",
        eval_query_file="query.10k.fbin", gt_file="gt.10k.ibin",
        remotes=tuple(
            RemoteFile(f"{_EYE}/images/img_emb_{i}.npy", f"img_emb_{i}.npy")
            for i in LAION_SHARDS
        ) + tuple(
            RemoteFile(f"{_EYE}/texts/text_emb_{i}.npy", f"text_emb_{i}.npy")
            for i in LAION_SHARDS
        ) + (
            RemoteFile(f"{_ZEN}/laion.query.10k.fbin", "query.10k.fbin"),
            RemoteFile(f"{_ZEN}/laion.gt.10k.ibin", "gt.10k.ibin"),
        ),
        notes="LAION-400M CLIP shards: base = image embeddings, training "
              "queries = text embeddings; npy shards exported to fbin.",
    ),
    "webvid-2.5M": DatasetSpec(
        name="webvid-2.5M", dim=512, metric="cosine", n_base=2_500_000,
        base_file="base.2.5M.fbin", train_query_file="query.train.2.5M.fbin",
        eval_query_file="query.10k.fbin", gt_file="gt.10k.ibin",
        remotes=(
            RemoteFile(
                "https://zenodo.org/records/11090378/files/"
                "clip.webvid.base.2.5M.fbin", "base.2.5M.fbin"),
            RemoteFile(f"{_ZEN}/webvid.query.train.2.5M.fbin",
                       "query.train.2.5M.fbin"),
            RemoteFile(f"{_ZEN}/webvid.query.10k.fbin", "query.10k.fbin"),
            RemoteFile(f"{_ZEN}/webvid.gt.10k.ibin", "gt.10k.ibin"),
        ),
        notes="CLIP-WebVid: base = mean-pooled video frame embeddings "
              "(see pool_frame_embeddings), queries = captions; cosine.",
    ),
}


def export_fbin_from_npy(npy_paths: Sequence[str], out_path: str,
                         normalize: bool = False,
                         chunk_rows: int = 262144) -> Tuple[int, int]:
    """Concatenate .npy shards into one .fbin, streaming.

    Behavior of reference export_fbin_from_npy.py:1-42 (shard concat, f32
    cast, `[npts u32][dim u32]` header) without its O(N^2) np.append —
    shards are memory-mapped and copied through a bounded buffer, so a
    10M x 512 export needs ~0.5 GB instead of 40 GB resident.
    """
    mms = [np.load(p, mmap_mode="r") for p in npy_paths]
    dim = int(mms[0].shape[1])
    for p, m in zip(npy_paths, mms):
        if m.ndim != 2 or int(m.shape[1]) != dim:
            raise ValueError(f"{p}: shape {m.shape} incompatible with "
                             f"dim {dim}")
    npts = int(sum(m.shape[0] for m in mms))
    with open(out_path, "wb") as f:
        f.write(_HEADER.pack(npts, dim))
        for m in mms:
            for s in range(0, m.shape[0], chunk_rows):
                block = np.asarray(m[s:s + chunk_rows], np.float32)
                if normalize:
                    nrm = np.linalg.norm(block, axis=1, keepdims=True)
                    nrm[nrm == 0] = 1.0
                    block = block / nrm
                f.write(block.tobytes())
    return npts, dim


def pool_frame_embeddings(frames: np.ndarray) -> np.ndarray:
    """clip4clip video pooling: normalize frame rows, mean, renormalize
    (reference prepare_for_clip_webvid.py:93-99). frames [F, d] → [d]."""
    frames = np.asarray(frames, np.float32)
    nrm = np.linalg.norm(frames, axis=1, keepdims=True)
    nrm[nrm == 0] = 1.0
    v = np.mean(frames / nrm, axis=0)
    n = np.linalg.norm(v)
    return v / (n if n > 0 else 1.0)


def pool_frame_embeddings_batch(frames: np.ndarray,
                                counts: np.ndarray) -> np.ndarray:
    """Device-batched pooling of many videos at once.

    `frames` [total_F, d] is the row-concatenation of every video's frame
    embeddings; `counts` [V] gives each video's frame count. Segment-mean
    on device replaces the reference's per-video Python loop
    (prepare_for_clip_webvid.py:80-104).
    """
    import jax.numpy as jnp
    from jax.ops import segment_sum

    counts = np.asarray(counts, np.int64)
    seg = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    x = jnp.asarray(np.asarray(frames, np.float32))
    x = x / jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    sums = segment_sum(x, jnp.asarray(seg), num_segments=len(counts))
    means = sums / jnp.asarray(counts, jnp.float32)[:, None]
    means = means / jnp.maximum(
        jnp.linalg.norm(means, axis=1, keepdims=True), 1e-12)
    return np.asarray(means)


def _download(remote: RemoteFile, dest: str, verbose: bool = True) -> None:
    rng = remote.byte_range()
    req = urllib.request.Request(remote.url)
    if rng is not None:
        req.add_header("Range", f"bytes=0-{rng}")
    if verbose:
        extra = f" (first {rng} bytes)" if rng else ""
        print(f"downloading {remote.url}{extra} -> {dest}")
    tmp = dest + ".part"
    with urllib.request.urlopen(req) as r, open(tmp, "wb") as f:
        while True:
            block = r.read(1 << 22)
            if not block:
                break
            f.write(block)
    if rng is not None:
        # the Range download trims the file mid-payload; rewrite the
        # header so npts matches the truncated row count. The size MUST
        # be checked first: a server that clamps/ignores Range can
        # return fewer bytes with a clean EOF, and truncate() would
        # zero-EXTEND the short file into a corrupt dataset that passes
        # every later size check.
        got = os.path.getsize(tmp)
        if got < rng:
            raise OSError(f"{remote.url}: short Range download "
                          f"({got} < {rng} bytes)")
        with open(tmp, "r+b") as f:
            f.write(_HEADER.pack(remote.head_points, remote.dim))
            f.truncate(rng)
    os.replace(tmp, dest)


def prepare(dataset: str, data_dir: str = "data",
            verbose: bool = True) -> DatasetSpec:
    """Fetch + assemble one registry dataset under `data_dir/<name>/`.

    Mirrors reference prepare_data.sh: skips files that already exist,
    downloads the rest, and for laion-10M exports the npy shards to the
    base/train fbins. Raises a RuntimeError listing outstanding URLs when
    the network is unreachable.
    """
    if dataset not in REGISTRY:
        raise ValueError(
            f"unknown dataset {dataset!r}; have {sorted(REGISTRY)}")
    spec = REGISTRY[dataset]
    ddir = os.path.join(data_dir, spec.name)
    os.makedirs(ddir, exist_ok=True)

    missing: List[RemoteFile] = [
        r for r in spec.remotes
        if not os.path.exists(os.path.join(ddir, r.filename))]
    failed: List[str] = []
    for r in missing:
        try:
            _download(r, os.path.join(ddir, r.filename), verbose=verbose)
        except (OSError, http.client.HTTPException) as e:
            # http.client errors (IncompleteRead, ...) are NOT OSError;
            # every transfer failure must land in the manual-staging
            # list rather than abort the batch
            failed.append(f"{r.url} -> {ddir}/{r.filename} ({e})")
    if failed:
        raise RuntimeError(
            "network fetch failed; stage these files manually and re-run:\n"
            + "\n".join(failed))

    if dataset == "laion-10M":
        base_out = os.path.join(ddir, spec.base_file)
        if not os.path.exists(base_out):
            export_fbin_from_npy(
                [os.path.join(ddir, f"img_emb_{i}.npy")
                 for i in LAION_SHARDS], base_out)
        train_out = os.path.join(ddir, spec.train_query_file)
        if not os.path.exists(train_out):
            export_fbin_from_npy(
                [os.path.join(ddir, f"text_emb_{i}.npy")
                 for i in LAION_SHARDS], train_out)

    # validate whatever is present (read_meta checks header vs file
    # size, catching truncated out-of-band staging)
    for fname in (spec.base_file, spec.train_query_file,
                  spec.eval_query_file):
        path = os.path.join(ddir, fname)
        if os.path.exists(path):
            n, d = read_meta(path)
            if d != spec.dim:
                raise RuntimeError(f"{path}: dim {d} != expected {spec.dim}")
    if spec.gt_file:
        path = os.path.join(ddir, spec.gt_file)
        if os.path.exists(path):
            read_gt_with_dist(path)  # size-validates the GT layout too
    return spec
