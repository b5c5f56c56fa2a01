"""NICE structured-document XML -> Markdown.

Behavioral parity with the reference converter
(src/processing/convert_xml_to_md.py): a recursive walk of
Chapters/Chapter/Sections nodes emitting '#'-headings by depth (chapters
start at H2 under the H1 document title), HTML content converted to
markdown with regex passes (p, h*, a, strong/b, em/i, br, li, tables with
caption + escaped pipes), recommendation-number headings pinned to H4,
document header lines for GuidanceNumber/LastModified, and collapsed
blank runs.

Counterpart of ``a_nice_rag_tpu/ingest/xml_to_md.py`` (a copy: it imports
no jax); the markdown is byte for byte the same.
"""

from __future__ import annotations

import glob
import os
import re
import xml.etree.ElementTree as ET
from html import unescape
from typing import List, Optional


def _clean(text: Optional[str]) -> str:
    if not text:
        return ""
    return re.sub(r"\s+", " ", unescape(text)).strip()


def _table_to_markdown(table_inner: str) -> str:
    caption = ""
    m = re.search(r"<caption[^>]*>(.*?)</caption>", table_inner, re.DOTALL)
    if m:
        caption = f"\n**{_clean(re.sub(r'<[^>]+>', '', m.group(1)))}**\n"
        table_inner = table_inner.replace(m.group(0), "")
    table_inner = re.sub(r"</?(tbody|thead|tfoot)[^>]*>", "", table_inner)
    rows = re.findall(r"<tr[^>]*>(.*?)</tr>", table_inner, re.DOTALL)
    if not rows:
        return "\n\n*[Table content could not be parsed]*\n\n"
    lines: List[str] = []
    for i, row in enumerate(rows):
        cells = re.findall(r"<(?:th|td)[^>]*>(.*?)</(?:th|td)>", row, re.DOTALL)
        if not cells:
            continue
        rendered = []
        for cell in cells:
            cell = re.sub(r"<p[^>]*>(.*?)</p>", r"\1", cell, flags=re.DOTALL)
            cell = _clean(re.sub(r"<[^>]+>", "", cell)).replace("|", "\\|")
            rendered.append(cell)
        lines.append("| " + " | ".join(rendered) + " |")
        if i == 0:
            lines.append("|" + "---|" * len(rendered))
    return caption + "\n".join(lines) + "\n\n"


def html_to_markdown(html: str, drop_heading: Optional[str] = None) -> str:
    """Regex HTML->markdown for the tag subset NICE content uses."""
    if not html:
        return ""
    html = re.sub(r"<!\[CDATA\[(.*?)\]\]>", r"\1", html, flags=re.DOTALL)
    if drop_heading:
        html = re.sub(
            r"<h\d[^>]*>\s*" + re.escape(_clean(drop_heading)) + r"\s*</h\d>",
            "",
            html,
            flags=re.IGNORECASE,
        )
    html = re.sub(r"<p[^>]*>(.*?)</p>", r"\1\n\n", html, flags=re.DOTALL)
    html = re.sub(
        r'<h(\d)[^>]*class="recommendation__number"[^>]*>(.*?)</h\d>',
        r"\n\n#### \2\n\n",
        html,
        flags=re.DOTALL,
    )
    html = re.sub(
        r"<h(\d)[^>]*>(.*?)</h\d>",
        lambda m: f"\n\n{'#' * int(m.group(1))} {_clean(m.group(2))}\n\n",
        html,
        flags=re.DOTALL,
    )
    html = re.sub(
        r'<a[^>]+href="([^"]+)"[^>]*>(.*?)</a>', r"[\2](\1)", html,
        flags=re.DOTALL,
    )
    html = re.sub(r"<(strong|b)>(.*?)</\1>", r"**\2**", html, flags=re.DOTALL)
    html = re.sub(r"<(em|i)>(.*?)</\1>", r"*\2*", html, flags=re.DOTALL)
    html = re.sub(r"<br\s*/?>", "\n", html)
    html = re.sub(
        r"<li[^>]*>(.*?)</li>",
        lambda m: "- "
        + _clean(re.sub(r"<p[^>]*>(.*?)</p>", r"\1", m.group(1), flags=re.DOTALL))
        + "\n",
        html,
        flags=re.DOTALL,
    )
    html = re.sub(r"</(ul|ol)>", "\n", html)
    html = re.sub(
        r"<table[^>]*>(.*?)</table>",
        lambda m: _table_to_markdown(m.group(1)),
        html,
        flags=re.DOTALL,
    )
    html = re.sub(r"<[^>]+>", "", html)
    html = re.sub(r"(\n\s*){3,}", "\n\n", html)
    return html.strip()


def _walk(node: ET.Element, level: int, out: List[str]) -> None:
    title_node = node.find("Title")
    title = _clean(title_node.text) if title_node is not None else ""
    if title:
        out.append(f"{'#' * level} {title}\n\n")
    content_node = node.find("Content")
    if content_node is not None and content_node.text:
        body = html_to_markdown(content_node.text, drop_heading=title)
        if body:
            out.append(body + "\n\n")
    sections = node.find("Sections")
    if sections is not None:
        for child in sections:
            _walk(child, level + 1, out)


def convert_xml_to_markdown(xml_text: str) -> str:
    """Convert one NICE structured-document XML string to markdown."""
    root = ET.fromstring(xml_text)
    out: List[str] = []
    title = root.find("Title")
    if title is not None and title.text:
        out.append(f"# {_clean(title.text)}\n\n")
    number = root.find("GuidanceNumber")
    if number is not None and number.text:
        out.append(f"**Guidance Number:** {_clean(number.text)}\n")
    modified = root.find("LastModified")
    if modified is not None and modified.text:
        out.append(f"**Last Modified:** {_clean(modified.text)}\n\n")
    chapters = root.find("Chapters")
    if chapters is not None:
        for chapter in chapters.findall("Chapter"):
            _walk(chapter, 2, out)
    return re.sub(r"\n{3,}", "\n\n", "".join(out)).strip()


def convert_file(xml_path: str, md_path: str) -> None:
    with open(xml_path, "r", encoding="utf-8") as f:
        md = convert_xml_to_markdown(f.read())
    os.makedirs(os.path.dirname(md_path) or ".", exist_ok=True)
    with open(md_path, "w", encoding="utf-8") as f:
        f.write(md)


def convert_directory(xml_dir: str, md_dir: str) -> int:
    """Convert every XML in a directory; returns the success count."""
    os.makedirs(md_dir, exist_ok=True)
    ok = 0
    for xml_file in sorted(glob.glob(os.path.join(xml_dir, "*.xml"))):
        base = os.path.splitext(os.path.basename(xml_file))[0]
        try:
            convert_file(xml_file, os.path.join(md_dir, f"{base}.md"))
            ok += 1
        except (ET.ParseError, OSError) as e:
            print(f"Failed to convert {xml_file}: {e}")
    return ok
