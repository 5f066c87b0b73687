#!/usr/bin/env python3
"""Write a training dataset as a tokenshard file (``.tshrd``) and its
manifest with the PyTorch port's modules alone (no JAX), so the shard
can be made on a machine that has only PyTorch.

The offline sources of ``scripts/prepare_data.py``, with the same flags
and the same output: for one input and tokenizer the ``.tshrd`` is the
same bytes and the manifest the same apart from ``created``.

    # a datasets.save_to_disk directory (needs the datasets package)
    python scripts/torch_prepare_data.py --out data/c4tiny.tshrd \
        --dataset-path /path/to/c4-tiny --seq-length 1024
    # one document per text file under a directory tree
    python scripts/torch_prepare_data.py --out data/local.tshrd \
        --text-dir /usr/lib/python3.12 --text-glob '*.py'
    python scripts/torch_prepare_data.py --out data/synth.tshrd  # synthetic corpus

``--tokenizer`` names an HF tokenizer to load from local files (needs
the transformers package); without it the byte-level tokenizer is used.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys
from datetime import datetime, timezone

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nanodiloco_tpu_torch.data.pipeline import (  # noqa: E402
    iter_hf_dataset_texts,
    pack_corpus_to_shard,
    synthetic_corpus,
)
from nanodiloco_tpu_torch.data.tokenizer import get_tokenizer  # noqa: E402
from nanodiloco_tpu_torch.data.tokenshard import ShardWriter, native_available  # noqa: E402


def iter_text_dir(root: str, patterns: str, max_docs: int = 0):
    """One document per matching file under ``root`` (recursive), in
    sorted path order, decoded permissively, one at a time. Raises
    SystemExit when nothing matches, before any tokenization."""
    pats = [p.strip() for p in patterns.split(",") if p.strip()]
    paths = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if any(fnmatch.fnmatch(name, p) for p in pats):
                paths.append(os.path.join(dirpath, name))
    paths.sort()
    if max_docs:
        paths = paths[:max_docs]
    if not paths:
        raise SystemExit(f"no text documents matched {patterns!r} under {root}")
    yielded = 0
    for path in paths:
        try:
            with open(path, "rb") as f:
                t = f.read().decode("utf-8", errors="ignore")
        except OSError:
            continue
        if t.strip():
            yielded += 1
            yield t
    if not yielded:
        raise SystemExit(
            f"all {len(paths)} documents matching {patterns!r} under {root} "
            "were empty or unreadable"
        )


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, help="output .tshrd path")
    p.add_argument("--dataset-path", default=None,
                   help="datasets.save_to_disk directory; default: synthetic corpus")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer name/path (local files); default byte-level")
    p.add_argument("--seq-length", type=int, default=1024)
    p.add_argument("--n-docs", type=int, default=20000,
                   help="synthetic corpus size (ignored with --dataset-path)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--text-dir", default=None,
                   help="build the corpus from a directory tree of plain-text files "
                        "(one document per file)")
    p.add_argument("--text-glob", default="*.txt,*.md,*.rst,*.py",
                   help="comma-separated patterns for --text-dir")
    p.add_argument("--max-docs", type=int, default=0,
                   help="cap the number of --text-dir documents (0 = all)")
    p.add_argument("--flush-rows", type=int, default=1024,
                   help="rows buffered before each append to the shard (bounds peak "
                        "memory; the output is identical at any value)")
    args = p.parse_args(argv)

    tokenizer = get_tokenizer(args.tokenizer)
    if args.text_dir:
        texts = iter_text_dir(args.text_dir, args.text_glob, args.max_docs)
        source = f"text-dir({args.text_dir}, {args.text_glob})"
    elif args.dataset_path:
        texts = iter_hf_dataset_texts(args.dataset_path)
        source = args.dataset_path
    else:
        texts = iter(synthetic_corpus(n_docs=args.n_docs, seed=args.seed))
        source = f"synthetic(n_docs={args.n_docs}, seed={args.seed})"

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with ShardWriter(args.out, args.seq_length) as w:
        n_rows = pack_corpus_to_shard(texts, tokenizer, args.seq_length, w,
                                      flush_rows=args.flush_rows)
    manifest = {
        "dataset": source,
        "tokenizer": args.tokenizer or "byte-level",
        "vocab_size": tokenizer.vocab_size,
        "seq_length": args.seq_length,
        "n_sequences": n_rows,
        "n_tokens": n_rows * args.seq_length,
        "native_writer": native_available(),
        "created": datetime.now(timezone.utc).isoformat(),
    }
    with open(args.out + ".manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps(manifest, indent=2))
    return manifest


if __name__ == "__main__":
    main()
