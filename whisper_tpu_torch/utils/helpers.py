"""Small host-side helpers.

Copied from whisper_tpu/utils/helpers.py (framework-free): the compression
ratio used by the temperature-fallback gate, timestamp formatting, the
segment start- and end-time lookups, and the CLI's argument parsers.
"""

import sys
import zlib
from typing import List, Optional

_SYSTEM_ENCODING = sys.getdefaultencoding()


def make_safe(string: str) -> str:
    """Make a string printable on non-UTF-8 terminals by replacing
    unencodable characters with '?'."""
    if _SYSTEM_ENCODING == "utf-8":
        return string
    return string.encode(_SYSTEM_ENCODING, errors="replace").decode(_SYSTEM_ENCODING)


def exact_div(x: int, y: int) -> int:
    if x % y != 0:
        raise ValueError(f"{x} is not divisible by {y}")
    return x // y


def str2bool(string: str) -> bool:
    table = {"True": True, "False": False}
    if string not in table:
        raise ValueError(f"Expected one of {set(table.keys())}, got {string}")
    return table[string]


def optional_int(string: str) -> Optional[int]:
    return None if string == "None" else int(string)


def optional_float(string: str) -> Optional[float]:
    return None if string == "None" else float(string)


def compression_ratio(text: str) -> float:
    """len(utf-8 bytes) / len(zlib-compressed bytes); high values indicate
    repetitive (likely degenerate) output."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    if seconds < 0:
        raise ValueError("non-negative timestamp expected")
    milliseconds = round(seconds * 1000.0)

    hours, milliseconds = divmod(milliseconds, 3_600_000)
    minutes, milliseconds = divmod(milliseconds, 60_000)
    seconds, milliseconds = divmod(milliseconds, 1_000)

    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{seconds:02d}{decimal_marker}{milliseconds:03d}"


def get_start(segments: List[dict]) -> Optional[float]:
    """Start time of the first word across segments (or first segment start)."""
    return next(
        (w["start"] for s in segments for w in s.get("words", [])),
        segments[0]["start"] if segments else None,
    )


def get_end(segments: List[dict]) -> Optional[float]:
    """End time of the last word across segments (or last segment end)."""
    return next(
        (w["end"] for s in reversed(segments) for w in reversed(s.get("words", []))),
        segments[-1]["end"] if segments else None,
    )
