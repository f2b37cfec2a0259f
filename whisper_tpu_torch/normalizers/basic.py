"""Language-agnostic text normalization for WER evaluation.

Copied from whisper_tpu/normalizers/basic.py: lowercase, strip bracketed
asides, map symbols and punctuation to spaces, optionally fold diacritics
(NFKD mark removal plus a table of Latin letters that do not decompose),
and squeeze whitespace. `split_letters` splits into grapheme clusters with
`re` and unicodedata (`_graphemes`), where the JAX package uses the
`regex` module's \\X.
"""

import re
import unicodedata

# Latin letters whose ASCII folding NFKD does not produce
_LATIN_FOLD = {
    "œ": "oe", "Œ": "OE",
    "ø": "o", "Ø": "O",
    "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS",
    "đ": "d", "Đ": "D",
    "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th",
    "ł": "l", "Ł": "L",
}  # fmt: skip


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Map symbols/punctuation to spaces and drop diacritics (category Mn),
    folding the non-decomposing Latin letters above."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in _LATIN_FOLD:
            out.append(_LATIN_FOLD[c])
        else:
            cat = unicodedata.category(c)
            if cat == "Mn":
                continue
            out.append(" " if cat[0] in "MSP" else c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Map symbols/punctuation to spaces, keeping diacritics."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


def _hangul(c: str) -> str:
    """The Hangul syllable type of a character: L, V, T, LV, LVT or ""."""
    o = ord(c)
    if 0x1100 <= o <= 0x115F or 0xA960 <= o <= 0xA97C:
        return "L"
    if 0x1160 <= o <= 0x11A7 or 0xD7B0 <= o <= 0xD7C6:
        return "V"
    if 0x11A8 <= o <= 0x11FF or 0xD7CB <= o <= 0xD7FB:
        return "T"
    if 0xAC00 <= o <= 0xD7A3:
        return "LV" if (o - 0xAC00) % 28 == 0 else "LVT"
    return ""


_HANGUL_JOINS = {
    ("L", "L"), ("L", "V"), ("L", "LV"), ("L", "LVT"),
    ("LV", "V"), ("LV", "T"), ("V", "V"), ("V", "T"), ("LVT", "T"), ("T", "T"),
}  # fmt: skip


def _joins(prev: str, c: str) -> bool:
    """Whether `c` continues the grapheme cluster that ends in `prev`: CR LF,
    combining marks, variation selectors, the zero-width joiner and what
    follows it, and Hangul syllable sequences (Unicode UAX #29's rules
    GB3, GB6-GB9a and a plain GB11)."""
    if prev == "\r":
        return c == "\n"
    if prev in "\r\n" or c in "\r\n":
        return False
    if unicodedata.category(c) in ("Mn", "Me", "Mc") or c == "\u200d" or prev == "\u200d":
        return True
    if 0xFE00 <= ord(c) <= 0xFE0F or 0xE0100 <= ord(c) <= 0xE01EF:
        return True
    return (_hangul(prev), _hangul(c)) in _HANGUL_JOINS


def _graphemes(s: str):
    clusters = []
    for c in s:
        if clusters and _joins(clusters[-1][-1], c):
            clusters[-1] += c
        else:
            clusters.append(c)
    return clusters


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # remove words between brackets
        s = re.sub(r"\(([^)]+?)\)", "", s)  # remove words between parenthesis
        s = self.clean(s).lower()

        if self.split_letters:
            s = " ".join(_graphemes(s))

        s = re.sub(r"\s+", " ", s)
        return s
