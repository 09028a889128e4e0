"""Minimal Praat TextGrid parser (long text format).

The port's own copy of ``livelyspeaker_tpu/data/textgrid.py`` (pure Python;
the port imports nothing of the JAX package). The reference reads BEAT's word-alignment TextGrids through the ``textgrid``
pip package (``scripts_beat/dataloaders/beat.py:252-269``); this is the
in-tree replacement (same spirit as the librosa/pymo replacements): parse
IntervalTier items into ``(mark, xmin, xmax)`` triples. Only the features
BEAT files use are supported — long-format files, interval tiers, quoted
text with doubled-quote escapes.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple

__all__ = ["Interval", "Tier", "parse_textgrid"]


class Interval(NamedTuple):
    mark: str
    xmin: float
    xmax: float


class Tier(NamedTuple):
    name: str
    intervals: List[Interval]


_NUM = re.compile(r"(xmin|xmax)\s*=\s*([-\d.eE+]+)")
_TEXT = re.compile(r'(text|mark|name)\s*=\s*"(.*)"\s*$')
_CLASS = re.compile(r'class\s*=\s*"(.*)"')


def parse_textgrid(path_or_text: str) -> List[Tier]:
    """Parse a long-format TextGrid into interval tiers."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text, encoding="utf-8") as f:
            text = f.read()

    tiers: List[Tier] = []
    cur_name = ""
    cur_intervals: List[Interval] = []
    in_interval = False
    xmin = xmax = 0.0
    mark = ""
    tier_class = ""

    def flush_interval():
        nonlocal in_interval
        if in_interval:
            cur_intervals.append(Interval(mark, xmin, xmax))
            in_interval = False

    def flush_tier():
        nonlocal cur_intervals, cur_name
        flush_interval()
        if cur_intervals or cur_name:
            if tier_class in ("", "IntervalTier"):
                tiers.append(Tier(cur_name, cur_intervals))
        cur_intervals, cur_name = [], ""

    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("item ") and "[]" not in line:
            flush_tier()
            tier_class = ""
            continue
        m = _CLASS.search(line)
        if m:
            tier_class = m.group(1)
            continue
        if line.startswith("intervals [") or line.startswith("points ["):
            flush_interval()
            in_interval = True
            mark = ""
            continue
        m = _NUM.search(line)
        if m:
            val = float(m.group(2))
            if in_interval:
                if m.group(1) == "xmin":
                    xmin = val
                else:
                    xmax = val
            continue
        m = _TEXT.search(line)
        if m:
            value = m.group(2).replace('""', '"')
            if m.group(1) == "name" and not in_interval:
                cur_name = value
            else:
                mark = value
    flush_tier()
    return tiers
