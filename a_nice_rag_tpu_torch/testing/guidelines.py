"""Seeded synthetic guidelines in NICE's structured-document XML: the input
of the ingestion pipeline's convert stage (``ingest/run_pipeline.py``)
where no download is possible.

Each document has the shape of the reference's downloads
(``{number}_structured_document.xml``): ``Guidance`` with ``Title``,
``GuidanceNumber``, ``LastModified`` and ``Chapters/Chapter`` nodes whose
``Sections/Section`` children (some nested one level deeper, a few
empty) each hold a ``Title`` and HTML in a CDATA ``Content``: paragraphs,
lists (some nested), tables with a caption and ``|`` in cells, links,
``strong`` / ``em``, ``br``, subheadings, recommendation-number headings
and entities. Words follow a Zipf law over a vocabulary of clinical
words, stopwords and made-up stems with their plural forms, and every
section holds a rare planted term of its own, so each chunk has a term
that finds it. The text is ASCII.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np

_CLINICAL = """
patient patients adult adults child children woman women treatment
treatments therapy therapies dose doses medicine medicines drug drugs
diagnosis diagnoses assessment assessments risk risks factor factors
blood pressure hypertension diabetes asthma infection infections
antibiotic antibiotics statin statins inhibitor inhibitors review reviews
referral referrals specialist specialists care carer carers service
services symptom symptoms sign signs test tests result results monitoring
management evidence study studies trial trials outcome outcomes analysis
analyses criteria criterion pregnancy pregnancies surgery procedure
procedures injection injections tablet tablets kidney liver heart lung
lungs stroke cancer cancers screening vaccine vaccines follow-up
consultation consultations practitioner practitioners guideline
guidelines recommendation recommendations pathway pathways support
education advice information decision decisions option options benefit
benefits harm harms people family families clinic clinics hospital
hospitals community primary secondary acute chronic severe mild
moderate first-line second-line daily weekly annually offer consider
discuss measure measured prescribe prescribed reduce increase assess
monitor refer start stop continue record explain check
""".split()
_STOPWORDS = """
the of and to in for with a is be on that by as or are should at if
their they this from not when who have can it been any all more than
""".split()
_ONSETS = ("b c d f g h k l m n p r t v pl pr tr cl gr br st ch th sh "
           "ph").split()
_VOWELS = ("a e i o u ai ea io ou").split()
_CODAS = ("", "n", "r", "l", "m", "t", "x", "nt", "st", "ph")
_PREFIXES = ("NG", "CG", "TA", "QS", "PH", "DG", "MTG", "IPG")


@dataclasses.dataclass
class GuidelineDoc:
    number: str
    xml: str
    sections: int  # sections with content, each with a planted term


def _vocabulary(rng: np.random.Generator, n_stems: int) -> List[str]:
    stems = set()
    while len(stems) < n_stems:
        n_syl = int(rng.integers(2, 4))
        stem = "".join(
            _ONSETS[rng.integers(len(_ONSETS))]
            + _VOWELS[rng.integers(len(_VOWELS))] for _ in range(n_syl))
        stems.add(stem + _CODAS[rng.integers(len(_CODAS))])
    words = []
    for stem in sorted(stems):
        words.append(stem)
        if stem.endswith(("x", "ch", "sh")):
            words.append(stem + "es")
        elif stem.endswith("y"):
            words.append(stem[:-1] + "ies")
        else:
            words.append(stem + "s")
    vocab = list(_STOPWORDS) + list(_CLINICAL) + words
    order = rng.permutation(len(vocab) - len(_STOPWORDS))
    # Stopwords lead the Zipf ranks, as in English text.
    return list(_STOPWORDS) + [vocab[len(_STOPWORDS) + i] for i in order]


def _planted(k: int) -> str:
    letters = "abcdefghijklmnopqrtuvwxyz"  # no "s": lemmas keep it whole
    code = ""
    while True:
        k, r = divmod(k, len(letters))
        code += letters[r]
        if not k:
            return "zr" + code + "q"


class _Writer:
    BLOCK = 1 << 20  # words drawn at once

    def __init__(self, rng: np.random.Generator, vocab: Sequence[str]):
        self.rng = rng
        self.vocab = vocab
        ranks = np.arange(len(vocab), dtype=np.float64)
        p = 1.0 / (ranks + 2.7) ** 1.07
        self.p = p / p.sum()
        self.words = np.zeros(0, np.int64)
        self.at = 0

    def take(self, n: int) -> List[str]:
        if self.at + n > len(self.words):
            self.words = self.rng.choice(len(self.vocab), self.BLOCK,
                                         p=self.p)
            self.at = 0
        out = [self.vocab[i] for i in self.words[self.at:self.at + n]]
        self.at += n
        return out

    def phrase(self, lo: int, hi: int) -> str:
        return " ".join(self.take(int(self.rng.integers(lo, hi))))

    def sentence(self) -> str:
        rng = self.rng
        words = self.take(int(rng.integers(8, 23)))
        roll = rng.random()
        j = int(rng.integers(len(words)))
        if roll < 0.06:
            words[j] = f"<strong>{words[j]}</strong>"
        elif roll < 0.11:
            words[j] = f"<em>{words[j]}</em>"
        elif roll < 0.15:
            words[j] = (f'<a href="https://www.nice.org.uk/guidance/'
                        f'ng{int(rng.integers(1, 250))}">{words[j]} '
                        f"{words[(j + 1) % len(words)]}</a>")
        elif roll < 0.18:
            words[j] = f"{words[j]} &amp; {words[(j + 2) % len(words)]}"
        elif roll < 0.20:
            words[j] = f"&lt;{int(rng.integers(2, 90))} {words[j]}"
        elif roll < 0.23:
            words[j] = f"{words[j]}, {rng.integers(1, 500)} mg"
        elif roll < 0.25:
            words[j] = f"{words[j]} cannot"
        elif roll < 0.27:
            words[j] = f"{words[j]}'s"
        text = " ".join(words)
        return text[0].upper() + text[1:] + "."

    def paragraph(self) -> str:
        n = int(self.rng.integers(2, 6))
        return " ".join(self.sentence() for _ in range(n))

    def items(self, depth: int) -> str:
        lis = []
        for _ in range(int(self.rng.integers(3, 7))):
            body = self.sentence()
            if depth == 0 and self.rng.random() < 0.15:
                body += self.items(1)
            lis.append(f"<li>{body}</li>")
        tag = "ol" if self.rng.random() < 0.3 else "ul"
        return f"<{tag}>{''.join(lis)}</{tag}>"

    def table(self) -> str:
        rng = self.rng
        cols = int(rng.integers(2, 5))
        head = "".join(f"<th>{self.phrase(1, 3).capitalize()}</th>"
                       for _ in range(cols))
        rows = []
        for _ in range(int(rng.integers(2, 6))):
            cells = []
            for _ in range(cols):
                cell = self.phrase(1, 5)
                if rng.random() < 0.2:
                    cell += f" {rng.integers(1, 40)}|{rng.integers(1, 40)} mg"
                elif rng.random() < 0.1:
                    cell = f"<p>{cell}</p>"
                cells.append(f"<td>{cell}</td>")
            rows.append(f"<tr>{''.join(cells)}</tr>")
        caption = (f"<caption>Table {rng.integers(1, 9)}: "
                   f"{self.phrase(2, 6)}</caption>")
        return (f"<table>{caption}<thead><tr>{head}</tr></thead>"
                f"<tbody>{''.join(rows)}</tbody></table>")

    def content(self, planted: str, rec: str) -> str:
        rng = self.rng
        blocks = []
        for b in range(int(rng.integers(2, 7))):
            roll = rng.random()
            if b == 0:
                words = self.paragraph().split(" ")
                words.insert(int(rng.integers(1, len(words))), planted)
                blocks.append(f"<p>{' '.join(words)}</p>")
            elif roll < 0.13:
                blocks.append(
                    f'<h3 class="recommendation__number">{rec}.{b}</h3>'
                    f"<p>{self.paragraph()}</p>")
            elif roll < 0.27:
                blocks.append(self.items(0))
            elif roll < 0.33:
                blocks.append(self.table())
            elif roll < 0.38:
                blocks.append(f"<h4>{self.phrase(2, 5).capitalize()}</h4>")
            elif roll < 0.42:
                blocks.append(f"<p>{self.sentence()}<br/>"
                              f"{self.sentence()}</p>")
            else:
                blocks.append(f"<p>{self.paragraph()}</p>")
        return "\n".join(blocks)


def _title(w: _Writer) -> str:
    title = w.phrase(2, 6).capitalize()
    if w.rng.random() < 0.1:
        title += " &amp; " + w.phrase(1, 3)
    return title


def guideline_documents(n: int, seed: int = 0,
                        chapters: Tuple[int, int] = (4, 8),
                        sections: Tuple[int, int] = (3, 10),
                        ) -> List[GuidelineDoc]:
    """``n`` guidelines of ``chapters`` x ``sections`` (inclusive ranges),
    the same documents for the same arguments."""
    rng = np.random.default_rng(seed)
    vocab = _vocabulary(rng, 1500)
    w = _Writer(rng, vocab)
    docs, planted = [], 0
    for g in range(n):
        number = f"{_PREFIXES[g % len(_PREFIXES)]}{g // len(_PREFIXES) + 1}"
        parts = [
            "<Guidance>",
            f"<Title>{_title(w)}</Title>",
            f"<GuidanceNumber>{number}</GuidanceNumber>",
            f"<LastModified>20{rng.integers(10, 25)}-"
            f"{rng.integers(1, 13):02d}-{rng.integers(1, 29):02d}"
            "</LastModified>",
            "<Chapters>",
        ]
        filled = 0

        def section(rec: str, depth: int) -> str:
            nonlocal planted, filled
            out = [f"<Section><Title>{_title(w)}</Title>"]
            if rng.random() >= 0.03:
                out.append("<Content><![CDATA["
                           + w.content(_planted(planted), rec)
                           + "]]></Content>")
                planted += 1
                filled += 1
            if depth == 0 and rng.random() < 0.1:
                out.append("<Sections>")
                out.extend(section(f"{rec}.{k + 1}", 1)
                           for k in range(int(rng.integers(1, 4))))
                out.append("</Sections>")
            out.append("</Section>")
            return "".join(out)

        for c in range(int(rng.integers(chapters[0], chapters[1] + 1))):
            parts.append(f"<Chapter><Title>{_title(w)}</Title>")
            if rng.random() < 0.5:
                parts.append(f"<Content><![CDATA[<p>{w.paragraph()}</p>]]>"
                             "</Content>")
            parts.append("<Sections>")
            parts.extend(
                section(f"{c + 1}.{s + 1}", 0)
                for s in range(int(rng.integers(sections[0],
                                                sections[1] + 1))))
            parts.append("</Sections></Chapter>")
        parts.append("</Chapters></Guidance>")
        docs.append(GuidelineDoc(number, "\n".join(parts), filled))
    return docs


def write_guidelines(xml_dir: str, docs: Sequence[GuidelineDoc]) -> None:
    """Write each document as ``{number}_structured_document.xml``, the
    download stage's file name."""
    os.makedirs(xml_dir, exist_ok=True)
    for d in docs:
        path = os.path.join(xml_dir, f"{d.number}_structured_document.xml")
        with open(path, "w", encoding="utf-8") as f:
            f.write(d.xml)
