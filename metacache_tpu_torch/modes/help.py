"""Help mode: topic documentation served from the package's docs/ files.

Mirrors main_mode_help (src/mode_help.cpp:35-110), which reads per-topic
text files from a docs/ directory installed next to the binary; here the
files ship inside the package (docs/*.txt).
"""
from __future__ import annotations

import os
import sys

from ..utils import ArgsParser

_DOCS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs")

# modes.h:37-92 topic list; 'quick' is the no-topic default page
_TOPICS = ("build", "query", "modify", "info", "annotate", "merge", "quick")


def _read_topic(topic: str) -> str:
    path = os.path.join(_DOCS_DIR, topic + ".txt")
    with open(path) as f:
        return f.read()


def main_mode_help(args: ArgsParser) -> int:
    topic = args.positionals[1] if len(args.positionals) > 1 else "quick"
    if topic == "help":
        topic = "quick"
    if topic not in _TOPICS:
        print(f"unknown help topic '{topic}'\n"
              f"available: {', '.join(t for t in _TOPICS if t != 'quick')}",
              file=sys.stderr)
        return 1
    try:
        print(_read_topic(topic))
    except OSError as e:
        print(f"documentation file missing: {e}", file=sys.stderr)
        return 1
    return 0
