"""Render the markdown docs (docs/*.md + docs/api/*.md) into a static HTML
site under docs/html/.

Stdlib-only equivalent of the reference's Hugo + pdoc HTML docs site
(docs/ in the reference repository: hugo-book layout + pdoc API HTML, built by
.github/workflows/hugo.yaml). This repo keeps markdown as the source of
truth (docs/, docs/api/ from scripts/gen_api_docs.py); this script adds the
browsable-HTML deliverable without any external toolchain:

    python scripts/gen_html_docs.py      # writes docs/html/*.html

The converter supports the markdown subset the docs actually use: ATX
headings, fenced code blocks, pipe tables, ordered/unordered lists, block
quotes, horizontal rules, links, inline code, bold/italic. Every page gets
the same sidebar navigation (guide pages + API reference) and a small
self-contained stylesheet — no JS, no external assets.
"""

from __future__ import annotations

import html
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
OUT = os.path.join(DOCS, "html")

STYLE = """
:root { --fg: #1a1a1a; --bg: #ffffff; --accent: #0b5394; --code-bg: #f5f6f8;
        --border: #e0e3e8; --side-bg: #f8f9fb; }
* { box-sizing: border-box; }
body { margin: 0; font: 16px/1.6 -apple-system, 'Segoe UI', Roboto, sans-serif;
       color: var(--fg); background: var(--bg); display: flex; }
nav { width: 270px; min-width: 270px; background: var(--side-bg);
      border-right: 1px solid var(--border); padding: 1.2rem 1rem;
      height: 100vh; overflow-y: auto; position: sticky; top: 0; }
nav h2 { font-size: 0.8rem; text-transform: uppercase; letter-spacing: 0.06em;
         color: #666; margin: 1.2rem 0 0.4rem; }
nav a { display: block; color: var(--fg); text-decoration: none;
        font-size: 0.9rem; padding: 0.12rem 0.4rem; border-radius: 4px;
        overflow-wrap: anywhere; }
nav a:hover { background: #e8ecf2; }
nav a.current { color: var(--accent); font-weight: 600; }
main { max-width: 56rem; padding: 2rem 3rem; min-width: 0; }
h1, h2, h3, h4 { line-height: 1.25; }
h1 { border-bottom: 2px solid var(--border); padding-bottom: 0.3rem; }
h2 { border-bottom: 1px solid var(--border); padding-bottom: 0.2rem;
     margin-top: 2rem; }
a { color: var(--accent); }
code { background: var(--code-bg); padding: 0.1em 0.35em; border-radius: 4px;
       font: 0.875em/1.5 'SF Mono', Consolas, Menlo, monospace; }
pre { background: var(--code-bg); border: 1px solid var(--border);
      border-radius: 6px; padding: 0.8rem 1rem; overflow-x: auto; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1rem 0; display: block;
        overflow-x: auto; }
th, td { border: 1px solid var(--border); padding: 0.35rem 0.7rem;
         text-align: left; font-size: 0.92rem; vertical-align: top; }
th { background: var(--side-bg); }
blockquote { border-left: 3px solid var(--accent); margin: 1rem 0;
             padding: 0.1rem 1rem; color: #444; background: var(--side-bg); }
hr { border: none; border-top: 1px solid var(--border); margin: 2rem 0; }
"""

_INLINE_CODE = re.compile(r"`([^`]+)`")
_BOLD = re.compile(r"\*\*([^*]+)\*\*")
_ITALIC = re.compile(r"(?<!\*)\*([^*\s][^*]*)\*(?!\*)")
_LINK = re.compile(r"\[([^\]]+)\]\(([^)\s]+)\)")


def _inline(text: str) -> str:
    """Inline markdown -> HTML on an already-escaped line. Inline code spans
    are substituted first (placeholder pass) so emphasis/link syntax inside
    backticks is left alone."""
    codes: list[str] = []

    def stash(m):
        codes.append(f"<code>{m.group(1)}</code>")
        return f"\x00{len(codes) - 1}\x00"

    text = _INLINE_CODE.sub(stash, text)

    def link(m):
        href = m.group(2)
        if href.endswith(".md"):
            href = href[:-3] + ".html"
        return f'<a href="{href}">{m.group(1)}</a>'

    text = _LINK.sub(link, text)
    text = _BOLD.sub(r"<strong>\1</strong>", text)
    text = _ITALIC.sub(r"<em>\1</em>", text)
    return re.sub(r"\x00(\d+)\x00", lambda m: codes[int(m.group(1))], text)


def md_to_html(md: str) -> str:
    out: list[str] = []
    lines = md.splitlines()
    i = 0
    in_list: list[str] = []  # stack of 'ul'/'ol'

    def close_lists(depth=0):
        while len(in_list) > depth:
            out.append(f"</{in_list.pop()}>")

    while i < len(lines):
        line = lines[i]
        stripped = line.strip()

        if stripped.startswith("```"):
            close_lists()
            block = []
            i += 1
            while i < len(lines) and not lines[i].strip().startswith("```"):
                block.append(lines[i])
                i += 1
            out.append("<pre><code>" + html.escape("\n".join(block)) + "</code></pre>")
            i += 1
            continue

        if not stripped:
            close_lists()
            i += 1
            continue

        m = re.match(r"(#{1,6})\s+(.*)", stripped)
        if m:
            close_lists()
            level = len(m.group(1))
            text = _inline(html.escape(m.group(2)))
            anchor = re.sub(r"[^a-z0-9]+", "-", m.group(2).lower()).strip("-")
            out.append(f'<h{level} id="{anchor}">{text}</h{level}>')
            i += 1
            continue

        if re.match(r"^(-{3,}|\*{3,}|_{3,})$", stripped):
            close_lists()
            out.append("<hr>")
            i += 1
            continue

        if stripped.startswith("|") and i + 1 < len(lines) and re.match(
            r"^\|[\s:|-]+\|?$", lines[i + 1].strip()
        ):
            close_lists()

            def cells(row):
                return [c.strip() for c in row.strip().strip("|").split("|")]

            out.append("<table><thead><tr>")
            out.extend(f"<th>{_inline(html.escape(c))}</th>" for c in cells(stripped))
            out.append("</tr></thead><tbody>")
            i += 2
            while i < len(lines) and lines[i].strip().startswith("|"):
                out.append("<tr>")
                out.extend(
                    f"<td>{_inline(html.escape(c))}</td>" for c in cells(lines[i])
                )
                out.append("</tr>")
                i += 1
            out.append("</tbody></table>")
            continue

        m = re.match(r"^(\s*)([-*]|\d+\.)\s+(.*)", line)
        if m:
            kind = "ul" if m.group(2) in ("-", "*") else "ol"
            depth = len(m.group(1)) // 2 + 1
            while len(in_list) > depth:
                out.append(f"</{in_list.pop()}>")
            while len(in_list) < depth:
                in_list.append(kind)
                out.append(f"<{kind}>")
            # continuation lines (indented beyond the marker) join the item
            item = [m.group(3)]
            while (
                i + 1 < len(lines)
                and lines[i + 1].strip()
                and not re.match(r"^(\s*)([-*]|\d+\.)\s+", lines[i + 1])
                and not lines[i + 1].lstrip().startswith(("#", "```", "|"))
                and (len(lines[i + 1]) - len(lines[i + 1].lstrip())) >= len(m.group(1)) + 2
            ):
                item.append(lines[i + 1].strip())
                i += 1
            out.append(f"<li>{_inline(html.escape(' '.join(item)))}</li>")
            i += 1
            continue

        if stripped.startswith(">"):
            close_lists()
            quote = []
            while i < len(lines) and lines[i].strip().startswith(">"):
                quote.append(lines[i].strip().lstrip(">").strip())
                i += 1
            out.append(
                "<blockquote><p>" + _inline(html.escape(" ".join(quote))) + "</p></blockquote>"
            )
            continue

        # paragraph: join consecutive plain lines
        para = [stripped]
        while (
            i + 1 < len(lines)
            and lines[i + 1].strip()
            and not lines[i + 1].lstrip().startswith(("#", "```", "|", ">", "- ", "* "))
            and not re.match(r"^\s*\d+\.\s", lines[i + 1])
            and not re.match(r"^(-{3,}|\*{3,})$", lines[i + 1].strip())
        ):
            para.append(lines[i + 1].strip())
            i += 1
        close_lists()
        out.append(f"<p>{_inline(html.escape(' '.join(para)))}</p>")
        i += 1

    close_lists()
    return "\n".join(out)


def _title_of(md: str, fallback: str) -> str:
    for line in md.splitlines():
        m = re.match(r"#\s+(.*)", line.strip())
        if m:
            return re.sub(r"[`*]", "", m.group(1))
    return fallback


def build():
    guide_pages = sorted(
        f for f in os.listdir(DOCS) if f.endswith(".md")
    )
    api_dir = os.path.join(DOCS, "api")
    api_pages = (
        sorted(f for f in os.listdir(api_dir) if f.endswith(".md"))
        if os.path.isdir(api_dir)
        else []
    )
    os.makedirs(OUT, exist_ok=True)

    pages = []  # (out_name, title, source_path, section)
    for f in guide_pages:
        src = os.path.join(DOCS, f)
        with open(src) as fh:
            md = fh.read()
        pages.append((f[:-3] + ".html", _title_of(md, f[:-3]), md, "Guide"))
    for f in api_pages:
        src = os.path.join(api_dir, f)
        with open(src) as fh:
            md = fh.read()
        name = f[:-3]
        title = name.replace("attosecondraytracing_tpu", "art_tpu").replace("_", ".")
        if f == "index.md":
            name, title = "api_index", "API index"
        pages.append((name + ".html", title, md, "API reference"))

    def nav_html(current: str) -> str:
        parts = ['<nav><h2><a href="index.html">attosecondraytracing_tpu</a></h2>']
        for section in ("Guide", "API reference"):
            parts.append(f"<h2>{section}</h2>")
            for out_name, title, _, sec in pages:
                if sec != section:
                    continue
                cls = ' class="current"' if out_name == current else ""
                parts.append(f'<a href="{out_name}"{cls}>{html.escape(title)}</a>')
        parts.append("</nav>")
        return "\n".join(parts)

    for out_name, title, md, _ in pages:
        body = md_to_html(md)
        # API cross-links written for the markdown tree
        body = body.replace('href="api/index.html"', 'href="api_index.html"')
        page = (
            "<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)} — attosecondraytracing_tpu</title>"
            f"<meta name='viewport' content='width=device-width, initial-scale=1'>"
            f"<style>{STYLE}</style></head><body>"
            f"{nav_html(out_name)}<main>{body}</main></body></html>"
        )
        with open(os.path.join(OUT, out_name), "w") as fh:
            fh.write(page)

    # landing page = usage guide if present, else the first page
    landing = "usage.html" if any(p[0] == "usage.html" for p in pages) else pages[0][0]
    with open(os.path.join(OUT, landing)) as fh:
        content = fh.read()
    with open(os.path.join(OUT, "index.html"), "w") as fh:
        fh.write(content)
    print(f"wrote {len(pages) + 1} pages to {os.path.relpath(OUT, ROOT)}/")


if __name__ == "__main__":
    sys.exit(build())
