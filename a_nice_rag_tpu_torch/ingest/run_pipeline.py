"""End-to-end ingestion CLI: the reference's processing-script chain as
one resumable command.

Stages (each idempotent; rerunning skips completed work):
  download -> convert -> chunk -> preprocess -> embed -> build-artifact

Usage:
    python -m a_nice_rag_tpu_torch.ingest.run_pipeline \
        --workdir data/nice --stages download,convert,chunk,preprocess \
        --guidelines NG136,CG127
    # with embedding access:
    ... --stages embed,artifact --embed-model voyage-3-large --device cuda

Counterpart of ``a_nice_rag_tpu/ingest/run_pipeline.py``: the same stages,
flags and files, plus ``--device``, where the artifact stage builds the
index (the card unless asked otherwise); no other stage touches a device.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger(__name__)

ALL_STAGES = ("download", "convert", "chunk", "preprocess", "embed",
              "artifact")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="data/nice")
    p.add_argument("--stages", default="convert,chunk,preprocess")
    p.add_argument("--guidelines", default=None,
                   help="comma-separated guideline numbers for download")
    p.add_argument("--max-tokens", type=int, default=600)
    p.add_argument("--min-tokens", type=int, default=200)
    p.add_argument("--overlap-tokens", type=int, default=50)
    p.add_argument("--embed-model", default="voyage-3-large")
    p.add_argument("--artifact", default="artifacts/nice_index")
    p.add_argument("--k1", type=float, default=1.7)
    p.add_argument("--b", type=float, default=0.83)
    p.add_argument("--epsilon", type=float, default=0.05)
    p.add_argument("--device", default="cuda",
                   help="torch device the artifact's index is built on")
    args = p.parse_args(argv)

    stages = [s.strip() for s in args.stages.split(",")]
    xml_dir = os.path.join(args.workdir, "xml")
    md_dir = os.path.join(args.workdir, "md")
    chunks_json = os.path.join(args.workdir, "chunked_guidelines.json")
    tokens_csv = os.path.join(args.workdir, "chunks_bm25.csv")
    chunk_db = os.path.join(
        args.workdir, f"{args.embed_model.replace('/', '_')}_chunks.db"
    )

    if "download" in stages:
        from a_nice_rag_tpu_torch.ingest.nice_api import download_all

        numbers = (args.guidelines or "").split(",")
        numbers = [n.strip() for n in numbers if n.strip()]
        if not numbers:
            raise SystemExit("--guidelines required for the download stage")
        results = download_all(numbers, xml_dir)
        ok = sum(1 for v in results.values() if v)
        logger.info("downloaded %d/%d guidelines", ok, len(numbers))

    if "convert" in stages:
        from a_nice_rag_tpu_torch.ingest.xml_to_md import convert_directory

        n = convert_directory(xml_dir, md_dir)
        logger.info("converted %d XML files", n)

    if "chunk" in stages:
        from a_nice_rag_tpu_torch.ingest.chunker import MarkdownChunker

        chunker = MarkdownChunker(
            max_tokens=args.max_tokens,
            min_tokens=args.min_tokens,
            overlap_tokens=args.overlap_tokens,
        )
        chunks = chunker.chunk_directory(md_dir, chunks_json)
        logger.info("chunked into %d chunks -> %s", len(chunks), chunks_json)

    if "preprocess" in stages:
        from a_nice_rag_tpu_torch.ingest.bm25_build import (
            preprocess_chunks,
            write_tokens_csv,
        )

        with open(chunks_json, "r", encoding="utf-8") as f:
            chunks = json.load(f)
        rows = preprocess_chunks(chunks)
        write_tokens_csv(rows, tokens_csv)
        logger.info("preprocessed %d chunks -> %s", len(rows), tokens_csv)

    if "embed" in stages:
        from a_nice_rag_tpu_torch.ingest.embed_db import (
            embed_chunks_incremental,
        )
        from a_nice_rag_tpu_torch.retrieval.embed import (
            OpenAIEmbedder,
            VoyageEmbedder,
        )

        with open(chunks_json, "r", encoding="utf-8") as f:
            chunks = json.load(f)
        if "voyage" in args.embed_model:
            embedder = VoyageEmbedder(model=args.embed_model)
        else:
            embedder = OpenAIEmbedder(model=args.embed_model)
        n = embed_chunks_incremental(chunks, embedder, chunk_db)
        logger.info("embedded %d new chunks -> %s", n, chunk_db)

    if "artifact" in stages:
        from a_nice_rag_tpu_torch.index.io import load_preprocessed_tokens_csv
        from a_nice_rag_tpu_torch.ingest.embed_db import (
            build_artifact_from_chunk_dbs,
        )

        tokens = load_preprocessed_tokens_csv(tokens_csv)
        build_artifact_from_chunk_dbs(
            {args.embed_model: chunk_db},
            args.artifact,
            token_lists_by_id=tokens,
            k1=args.k1,
            b=args.b,
            epsilon=args.epsilon,
            device=args.device,
        )
        logger.info("artifact written -> %s", args.artifact)


if __name__ == "__main__":
    main()
