"""gst-inspect analog: discover registered elements and sub-plugins.

Copy of ``nnstreamer_tpu/tools/inspect.py`` over this package's registry
(reference analog: ``gst-inspect-1.0``):

    python -m nnstreamer_tpu_torch.tools.inspect                 # everything
    python -m nnstreamer_tpu_torch.tools.inspect tensor_filter   # one element
    python -m nnstreamer_tpu_torch.tools.inspect --kind filter   # one registry

Detail view prints the registered class, its aliases, and the docstring
(the framework documents element properties in docstrings, the analog of
gst-inspect's property table).
"""

from __future__ import annotations

import argparse
import inspect as _inspect
import sys
from typing import Optional

from ..core.registry import (
    KIND_CONVERTER,
    KIND_DECODER,
    KIND_ELEMENT,
    KIND_FILTER,
    KIND_TRAINER,
    aliases_of,
    lookup,
    names,
)

_KINDS = {
    "element": KIND_ELEMENT,
    "filter": KIND_FILTER,
    "decoder": KIND_DECODER,
    "converter": KIND_CONVERTER,
    "trainer": KIND_TRAINER,
}


def _first_line(doc: Optional[str]) -> str:
    if not doc:
        return ""
    return doc.strip().splitlines()[0]


def list_all(kind_filter: Optional[str] = None, out=None) -> None:
    out = out or sys.stdout
    for label, kind in _KINDS.items():
        if kind_filter and label != kind_filter:
            continue
        entries = names(kind)
        if not entries:
            continue
        out.write(f"== {label} ({len(entries)}) ==\n")
        for n in sorted(entries):
            cls = lookup(kind, n)
            summary = _first_line(cls.__doc__)
            if not summary:  # some classes document in their module header
                mod = sys.modules.get(cls.__module__)
                summary = _first_line(getattr(mod, "__doc__", ""))
            out.write(f"  {n:28s} {summary}\n")
        out.write("\n")


def show(name: str, out=None) -> bool:
    out = out or sys.stdout
    found = False
    for label, kind in _KINDS.items():
        cls = lookup(kind, name)
        if cls is None:
            continue
        found = True
        mod = cls.__module__
        out.write(f"{label}: {name}\n")
        out.write(f"  class:  {mod}.{cls.__name__}\n")
        al = aliases_of(kind, name)
        if al:
            out.write(f"  aliases: {', '.join(al)}\n")
        try:
            out.write(f"  source: {_inspect.getsourcefile(cls)}\n")
        except TypeError:
            pass
        doc = _inspect.getdoc(cls)
        if doc:
            out.write("\n" + "\n".join(f"  {l}" for l in doc.splitlines()))
            out.write("\n")
        out.write("\n")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="List registered elements / sub-plugins (gst-inspect "
                    "analog)")
    ap.add_argument("name", nargs="?", help="show one entry in detail")
    ap.add_argument("--kind", choices=sorted(_KINDS),
                    help="restrict the listing to one registry")
    args = ap.parse_args(argv)
    if args.name:
        if not show(args.name):
            print(f"no element or sub-plugin named {args.name!r}",
                  file=sys.stderr)
            return 1
        return 0
    list_all(args.kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
