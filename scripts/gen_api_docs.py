"""Generate markdown API documentation for attosecondraytracing_tpu.

Stdlib-only replacement for the reference's pdoc-generated API site
(docs/src/static/api/ in the reference repository): walks the package with ``inspect``,
emits one markdown file per module into docs/api/ plus an index. Run from the
repo root:

    JAX_PLATFORMS=cpu python scripts/gen_api_docs.py

Re-run after changing public signatures/docstrings; the output is committed
so the docs are browsable without running anything.
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACKAGE = "attosecondraytracing_tpu"
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs", "api")


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _own_members(mod):
    """Classes and functions *defined* in this module (not re-exports),
    plus explicit re-exports listed in __all__."""
    allowed = getattr(mod, "__all__", None)
    classes, functions = [], []
    for name, obj in inspect.getmembers(mod):
        if not _is_public(name):
            continue
        if allowed is not None and name not in allowed:
            continue
        here = getattr(obj, "__module__", None) == mod.__name__ or allowed is not None
        if inspect.isclass(obj) and here:
            classes.append((name, obj))
        elif (inspect.isfunction(obj) or inspect.isbuiltin(obj)) and here:
            functions.append((name, obj))
    return classes, functions


def _render_class(name: str, cls) -> list[str]:
    lines = [f"### class `{name}{_signature(cls)}`", ""]
    doc = _doc(cls)
    if doc:
        lines += [doc, ""]
    # NamedTuple field listing (the framework's core data structures)
    fields = getattr(cls, "_fields", None)
    if fields:
        lines += ["Fields: " + ", ".join(f"`{f}`" for f in fields), ""]
    for mname, meth in inspect.getmembers(cls):
        if not _is_public(mname) or mname in ("count", "index", "mro"):
            continue
        owner = next((k for k in cls.__mro__ if mname in vars(k)), None)
        if owner is not cls:
            continue  # inherited; documented on the base
        raw = vars(cls)[mname]
        if isinstance(raw, property):
            lines += [f"- **`.{mname}`** *(property)*"]
            d = _doc(raw)
            if d:
                lines += [f"  — {d.splitlines()[0]}"]
        elif inspect.isfunction(raw) or isinstance(raw, (staticmethod, classmethod)):
            fn = raw.__func__ if isinstance(raw, (staticmethod, classmethod)) else raw
            lines += [f"- **`.{mname}{_signature(fn)}`**"]
            d = _doc(fn)
            if d:
                lines += [f"  — {d.splitlines()[0]}"]
    lines += [""]
    return lines


def _render_function(name: str, fn) -> list[str]:
    lines = [f"### `{name}{_signature(fn)}`", ""]
    doc = _doc(fn)
    if doc:
        lines += [doc, ""]
    return lines


def render_module(modname: str) -> str | None:
    mod = importlib.import_module(modname)
    classes, functions = _own_members(mod)
    lines = [f"# `{modname}`", ""]
    doc = _doc(mod)
    if doc:
        lines += [doc, ""]
    if not (classes or functions or doc):
        return None
    if classes:
        lines += ["## Classes", ""]
        for name, cls in classes:
            lines += _render_class(name, cls)
    if functions:
        lines += ["## Functions", ""]
        for name, fn in functions:
            lines += _render_function(name, fn)
    return "\n".join(lines).rstrip() + "\n"


def main():
    pkg = importlib.import_module(PACKAGE)
    modnames = [PACKAGE]
    for info in pkgutil.walk_packages(pkg.__path__, prefix=PACKAGE + "."):
        modnames.append(info.name)

    if os.path.isdir(OUT_DIR):
        shutil.rmtree(OUT_DIR)
    os.makedirs(OUT_DIR)

    index = [
        "# API reference",
        "",
        f"Generated by `scripts/gen_api_docs.py` — do not edit by hand.",
        "",
    ]
    for modname in sorted(modnames):
        md = render_module(modname)
        if md is None:
            continue
        fname = modname.replace(".", "_") + ".md"
        with open(os.path.join(OUT_DIR, fname), "w") as f:
            f.write(md)
        mod = importlib.import_module(modname)
        hook = (_doc(mod).splitlines() or [""])[0]
        index.append(f"- [`{modname}`]({fname}) — {hook}")
    with open(os.path.join(OUT_DIR, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(index) - 4} module pages to {OUT_DIR}")


if __name__ == "__main__":
    main()
