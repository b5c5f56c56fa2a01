"""Hierarchical heading-aware markdown chunker.

Algorithm parity with the reference chunker (src/processing/chunk_mds.py,
defaults max=600/min=200/overlap=50 at :832):

1. split at H1/H2 headings (priority whole-sections like "Overview" kept
   intact when they fit);
2. oversized sections recurse into their direct child headings (minimum
   deeper level present);
3. still-oversized content splits at scored candidate points — subsection
   headings (priority 1) and blank-line paragraph gaps (priority 2) —
   choosing, for each of ceil(tokens/max) target positions, the candidate
   minimizing |position - target| + 50*priority + |chunk imbalance|, with
   a 50-token minimum advance;
4. split chunks gain ±3-sentence overlap bracketed as "[...]" when it
   fits the overlap budget;
5. a paragraph-accumulation fallback handles content with no candidates;
6. near-duplicates are dropped via Jaccard > 0.85 on the first 500 chars;
7. consecutive under-min chunks merge (titles joined with " & ", >3
   collapsed to "first & N more sections") while staying under max.

Chunk ids follow "{guideline}_{section title}[ - Part n]"
(chunk_mds.py:503-504).

Counterpart of ``a_nice_rag_tpu/ingest/chunker.py`` (a copy: it imports no
jax); the chunks and their JSON file are the same.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence

from a_nice_rag_tpu_torch.ingest.tokens import TokenCounter

_HEADING_RE = re.compile(r"^(#{1,6})\s+(.+)$")
_SENTENCE_SPLIT_RE = re.compile(r"(?<=[.!?])\s+")
_GUIDELINE_RE = re.compile(r"^([A-Z]{1,3}\d+)")

PRIORITY_SECTION_TITLES = frozenset(
    {
        "overview",
        "background",
        "context",
        "terms used in this guideline",
        "update information",
        "introduction",
        "scope",
        "methodology",
    }
)


@dataclasses.dataclass
class Chunk:
    title: str
    content: str
    tokens: int
    source: str = ""
    source_file: str = ""
    heading_level: Optional[int] = None
    parent_section: Optional[str] = None
    part_number: Optional[int] = None
    total_parts: Optional[int] = None
    split_type: Optional[str] = None
    merged_sections: Optional[List[str]] = None

    def to_dict(self) -> Dict:
        d = {
            "title": self.title,
            "content": self.content,
            "tokens": self.tokens,
            "source": self.source,
            "source_file": self.source_file,
        }
        for k in ("heading_level", "parent_section", "part_number",
                  "total_parts", "split_type", "merged_sections"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


@dataclasses.dataclass
class _Heading:
    level: int
    title: str
    line: int


def parse_headings(lines: Sequence[str]) -> List[_Heading]:
    out = []
    for i, line in enumerate(lines):
        m = _HEADING_RE.match(line.strip())
        if m:
            out.append(_Heading(len(m.group(1)), m.group(2).strip(), i))
    return out


def guideline_number(file_path: str) -> str:
    name = os.path.basename(file_path)
    m = _GUIDELINE_RE.match(name)
    return m.group(1) if m else os.path.splitext(name)[0]


@dataclasses.dataclass
class _SplitPoint:
    line: int
    priority: int  # 1 = subsection heading, 2 = paragraph gap
    kind: str


def _candidate_splits(lines: Sequence[str]) -> List[_SplitPoint]:
    points = []
    for i, line in enumerate(lines):
        if re.match(r"^#{3,6}\s+", line.strip()):
            points.append(_SplitPoint(i, 1, "subsection"))
        elif (
            line.strip() == ""
            and 0 < i < len(lines) - 1
            and lines[i - 1].strip()
            and lines[i + 1].strip()
        ):
            points.append(_SplitPoint(i, 2, "paragraph"))
    return points


class MarkdownChunker:
    def __init__(
        self,
        max_tokens: int = 600,
        min_tokens: int = 200,
        overlap_tokens: int = 50,
        token_counter: Optional[TokenCounter] = None,
    ):
        self.max_tokens = max_tokens
        self.min_tokens = min_tokens
        self.overlap_tokens = overlap_tokens
        self.count = token_counter or TokenCounter()

    # -- overlap ---------------------------------------------------------

    def _sentence_overlap(
        self, lines: Sequence[str], at: int, before: bool
    ) -> str:
        if before:
            window = "\n".join(lines[max(0, at - 10) : at])
            sentences = _SENTENCE_SPLIT_RE.split(window)
            take = sentences[-3:]
        else:
            window = "\n".join(lines[at : min(len(lines), at + 10)])
            sentences = _SENTENCE_SPLIT_RE.split(window)
            take = sentences[:3]
        return " ".join(take).strip()

    # -- scored splitting --------------------------------------------------

    def _scored_split(self, content: str, base_title: str) -> List[Chunk]:
        lines = content.split("\n")
        total = self.count(content)
        n_target = max(2, -(-total // self.max_tokens))
        per_chunk = total // n_target
        points = _candidate_splits(lines)
        if not points:
            return self._paragraph_fallback(content, base_title)

        line_tok = [self.count(l) for l in lines]
        prefix = [0]
        for t in line_tok:
            prefix.append(prefix[-1] + t)

        chosen: List[_SplitPoint] = []
        consumed = 0
        for i in range(1, n_target):
            target = i * per_chunk
            best, best_score = None, float("inf")
            for pt in points:
                at_tokens = prefix[pt.line]
                if at_tokens - consumed < 50:
                    continue
                score = (
                    abs(at_tokens - target)
                    + 50 * pt.priority
                    + abs(at_tokens - consumed - per_chunk)
                )
                if score < best_score:
                    best, best_score = pt, score
            if best is not None:
                chosen.append(best)
                consumed = prefix[best.line]

        pieces: List[Chunk] = []
        start = 0
        boundaries: List[Optional[_SplitPoint]] = list(chosen) + [None]
        for i, pt in enumerate(boundaries):
            end = pt.line if pt is not None else len(lines)
            body = "\n".join(lines[start:end]).strip()
            if not body or self.count(body) < 10:
                start = end
                continue
            if i > 0 and self.overlap_tokens > 0:
                ov = self._sentence_overlap(lines, start, before=True)
                if ov and self.count(ov) <= self.overlap_tokens:
                    body = f"[...{ov}]\n\n{body}"
            if pt is not None and self.overlap_tokens > 0:
                ov = self._sentence_overlap(lines, end, before=False)
                if ov and self.count(ov) <= self.overlap_tokens:
                    body = f"{body}\n\n[...{ov}]"
            part = len(pieces) + 1
            pieces.append(
                Chunk(
                    title=(
                        f"{base_title} - Part {part}" if chosen else base_title
                    ),
                    content=body,
                    tokens=self.count(body),
                    part_number=part,
                    split_type=pt.kind if pt is not None else "end",
                )
            )
            start = end
        if not pieces:
            return self._paragraph_fallback(content, base_title)
        for c in pieces:
            c.total_parts = len(pieces)
        return pieces

    def _paragraph_fallback(self, content: str, base_title: str) -> List[Chunk]:
        out: List[Chunk] = []
        acc: List[str] = []
        acc_tokens = 0
        part = 1

        def flush():
            nonlocal acc, acc_tokens, part
            if not acc:
                return
            body = "\n\n".join(acc)
            if part > 1 and self.overlap_tokens > 0:
                tail = acc[-1][-100:]
                if self.count(tail) <= self.overlap_tokens:
                    body = f"[...{tail}]\n\n{body}"
            out.append(
                Chunk(
                    title=f"{base_title} - Part {part}" if part > 1 else base_title,
                    content=body,
                    tokens=acc_tokens,
                    part_number=part,
                    split_type="paragraph",
                )
            )
            acc, acc_tokens = [], 0
            part += 1

        for para in content.split("\n\n"):
            para = para.strip()
            if not para:
                continue
            t = self.count(para)
            if acc and acc_tokens + t > self.max_tokens:
                flush()
            acc.append(para)
            acc_tokens += t
        flush()
        return out

    # -- section handling --------------------------------------------------

    def _emit_section(
        self,
        content: str,
        base_title: str,
        guideline: str,
        file_path: str,
        level: Optional[int],
        parent: Optional[str],
        out: List[Chunk],
    ) -> None:
        tokens = self.count(content)
        if tokens <= self.max_tokens:
            out.append(
                Chunk(
                    title=f"{guideline}_{base_title}",
                    content=content,
                    tokens=tokens,
                    source=guideline,
                    source_file=file_path,
                    heading_level=level,
                    parent_section=parent,
                )
            )
            return
        for piece in self._scored_split(content, base_title):
            piece.title = f"{guideline}_{piece.title}"
            piece.source = guideline
            piece.source_file = file_path
            piece.heading_level = level
            piece.parent_section = parent
            out.append(piece)

    def chunk_markdown(self, content: str, file_path: str = "doc.md") -> List[Chunk]:
        guideline = guideline_number(file_path)
        lines = content.split("\n")
        headings = parse_headings(lines)
        base_name = os.path.basename(file_path).replace(".md", "")
        chunks: List[Chunk] = []

        if not headings:
            self._emit_section(
                content, base_name, guideline, file_path, None, None, chunks
            )
            return self._postprocess(chunks)

        top = [h for h in headings if h.level <= 2]
        for i, h in enumerate(top):
            end = top[i + 1].line if i + 1 < len(top) else len(lines)
            section = "\n".join(lines[h.line : end]).strip()
            tokens = self.count(section)
            is_priority = h.title.lower() in PRIORITY_SECTION_TITLES

            if tokens <= self.max_tokens or is_priority:
                # Fits, or is a priority section (priority sections are
                # scored-split directly when oversized, never recursed).
                self._emit_section(
                    section, h.title, guideline, file_path, h.level, None, chunks
                )
                continue

            # Recurse into direct children at the shallowest deeper level.
            section_lines = section.split("\n")
            subs = [
                sh
                for sh in parse_headings(section_lines)
                if sh.level > h.level
            ]
            if not subs:
                self._emit_section(
                    section, h.title, guideline, file_path, h.level, None, chunks
                )
                continue
            child_level = min(sh.level for sh in subs)
            children = [sh for sh in subs if sh.level == child_level]
            for k, sh in enumerate(children):
                sub_end = (
                    children[k + 1].line if k + 1 < len(children)
                    else len(section_lines)
                )
                sub = "\n".join(section_lines[sh.line : sub_end]).strip()
                self._emit_section(
                    sub,
                    f"{h.title}: {sh.title}",
                    guideline,
                    file_path,
                    sh.level,
                    h.title,
                    chunks,
                )

        return self._postprocess(chunks)

    def chunk_file(self, file_path: str) -> List[Chunk]:
        with open(file_path, "r", encoding="utf-8") as f:
            return self.chunk_markdown(f.read(), file_path)

    # -- postprocessing ----------------------------------------------------

    def _postprocess(self, chunks: List[Chunk]) -> List[Chunk]:
        return self._merge_small(self._dedup(chunks))

    @staticmethod
    def _dedup(chunks: List[Chunk]) -> List[Chunk]:
        """Drop near-duplicates: Jaccard > 0.85 on first-500-char word sets."""
        kept: List[Chunk] = []
        seen: List[set] = []
        for c in chunks:
            words = set(c.content[:500].strip().lower().split())
            dup = False
            for other in seen:
                union = words | other
                if union and len(words & other) / len(union) > 0.85:
                    dup = True
                    break
            if not dup:
                seen.append(words)
                kept.append(c)
        return kept

    def _merge_title(self, titles: List[str]) -> str:
        parts, prefix = [], None
        for t in titles:
            if "_" in t:
                src, rest = t.split("_", 1)
                prefix = prefix or src
                parts.append(rest)
            else:
                parts.append(t)
        joined = (
            " & ".join(parts)
            if len(parts) <= 3
            else f"{parts[0]} & {len(parts) - 1} more sections"
        )
        return f"{prefix}_{joined}" if prefix else joined

    def _merge_small(self, chunks: List[Chunk]) -> List[Chunk]:
        out: List[Chunk] = []
        i = 0
        while i < len(chunks):
            cur = chunks[i]
            if cur.tokens >= self.min_tokens:
                # A big chunk absorbs one small follower if it fits.
                nxt = chunks[i + 1] if i + 1 < len(chunks) else None
                if (
                    nxt is not None
                    and nxt.tokens < self.min_tokens
                    and cur.tokens + nxt.tokens <= self.max_tokens
                ):
                    merged = dataclasses.replace(
                        cur,
                        title=self._merge_title([cur.title, nxt.title]),
                        content=cur.content + "\n\n" + nxt.content,
                        tokens=cur.tokens + nxt.tokens,
                        merged_sections=[cur.title, nxt.title],
                    )
                    out.append(merged)
                    i += 2
                else:
                    out.append(cur)
                    i += 1
                continue
            # Small chunk: accumulate followers until min reached / max hit.
            group = [cur]
            total = cur.tokens
            j = i + 1
            while j < len(chunks) and total < self.max_tokens:
                nxt = chunks[j]
                if total + nxt.tokens > self.max_tokens:
                    break
                if nxt.tokens >= self.min_tokens and total >= self.min_tokens:
                    break
                group.append(nxt)
                total += nxt.tokens
                j += 1
            if len(group) == 1:
                out.append(cur)
                i += 1
                continue
            parents = {c.parent_section for c in group}
            merged = dataclasses.replace(
                cur,
                title=self._merge_title([c.title for c in group]),
                content="\n\n".join(c.content for c in group),
                tokens=total,
                heading_level=min(
                    (c.heading_level or 6) for c in group
                ),
                parent_section=(
                    group[0].parent_section if len(parents) == 1 else None
                ),
                merged_sections=[c.title for c in group],
            )
            out.append(merged)
            i = j
        return out

    # -- directory driver ----------------------------------------------------

    def chunk_directory(
        self, input_dir: str, output_file: Optional[str] = None
    ) -> List[Chunk]:
        import glob

        all_chunks: List[Chunk] = []
        for path in sorted(glob.glob(os.path.join(input_dir, "*.md"))):
            all_chunks.extend(self.chunk_file(path))
        if output_file:
            os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
            with open(output_file, "w", encoding="utf-8") as f:
                json.dump([c.to_dict() for c in all_chunks], f, indent=1)
        return all_chunks
