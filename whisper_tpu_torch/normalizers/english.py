"""English text normalization for WER evaluation.

Copied from whisper_tpu/normalizers/english.py (framework-free, `re` only):
spelled-out numbers become numerals (with ordinal and plural suffixes,
currency prefixes, decimal points, "double"/"triple" repeats, "and a half"
read as "point five"), contractions and titles expand, filler words drop,
British spellings map to American (the port's own copy of english.json),
and symbols not next to a digit are stripped.

The number pass is a state machine over a 3-word window: a pending value
(an int while arithmetic composition is possible, a str once digits must be
concatenated) and a pending sign or currency prefix; each word class has
its handler.
"""

import json
import os
import re
from fractions import Fraction
from typing import Iterator, List, Match, Optional, Union

from .basic import remove_symbols_and_diacritics

_ONES_NAMES = [
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]  # fmt: skip

_TENS_NAMES = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}  # fmt: skip

_MULTIPLIER_NAMES = {
    "hundred": 100,
    "thousand": 10**3,
    "million": 10**6,
    "billion": 10**9,
    "trillion": 10**12,
    "quadrillion": 10**15,
    "quintillion": 10**18,
    "sextillion": 10**21,
    "septillion": 10**24,
    "octillion": 10**27,
    "nonillion": 10**30,
    "decillion": 10**33,
}

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


def _as_fraction(s) -> Optional[Fraction]:
    try:
        return Fraction(s)
    except ValueError:
        return None


class EnglishNumberNormalizer:
    """Convert spelled-out numbers to arabic numerals: keeps suffixes
    (1960s, 274th, 32nd), spells currency symbols after the number
    ($20 million -> 20000000 dollars), keeps "one"/"ones" literal, and reads
    successive single digits nominally (one oh one -> 101)."""

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {name: i + 1 for i, name in enumerate(_ONES_NAMES)}
        self.ones_plural = {
            ("sixes" if name == "six" else name + "s"): (value, "s")
            for name, value in self.ones.items()
        }
        ordinal_irregular = {
            "zeroth": (0, "th"),
            "first": (1, "st"),
            "second": (2, "nd"),
            "third": (3, "rd"),
            "fifth": (5, "th"),
            "twelfth": (12, "th"),
        }
        self.ones_ordinal = {
            **ordinal_irregular,
            **{
                name + ("h" if name.endswith("t") else "th"): (value, "th")
                for name, value in self.ones.items()
                if value > 3 and value not in (5, 12)
            },
        }
        self.ones_suffixed = {**self.ones_plural, **self.ones_ordinal}

        self.tens = dict(_TENS_NAMES)
        self.tens_plural = {
            name.replace("y", "ies"): (value, "s") for name, value in self.tens.items()
        }
        self.tens_ordinal = {
            name.replace("y", "ieth"): (value, "th")
            for name, value in self.tens.items()
        }
        self.tens_suffixed = {**self.tens_plural, **self.tens_ordinal}

        self.multipliers = dict(_MULTIPLIER_NAMES)
        self.multipliers_plural = {
            name + "s": (value, "s") for name, value in self.multipliers.items()
        }
        self.multipliers_ordinal = {
            name + "th": (value, "th") for name, value in self.multipliers.items()
        }
        self.multipliers_suffixed = {
            **self.multipliers_plural,
            **self.multipliers_ordinal,
        }

        self.decimals = {*self.ones, *self.tens, *self.zeros}

        self.preceding_prefixers = {
            "minus": "-",
            "negative": "-",
            "plus": "+",
            "positive": "+",
        }
        self.following_prefixers = {
            "pound": "£", "pounds": "£",
            "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$",
            "cent": "¢", "cents": "¢",
        }  # fmt: skip
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = set().union(
            self.zeros,
            self.ones,
            self.ones_suffixed,
            self.tens,
            self.tens_suffixed,
            self.multipliers,
            self.multipliers_suffixed,
            self.preceding_prefixers,
            self.following_prefixers,
            self.suffixers,
            self.specials,
        )
        self.literal_words = {"one", "ones"}

    # ---- the word-stream state machine ----------------------------------

    def process_words(self, words: List[str]) -> Iterator[str]:
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None
        skip = False

        def flush(result: Union[str, int]) -> str:
            nonlocal prefix, value
            result = str(result)
            if prefix is not None:
                result = prefix + result
            value = None
            prefix = None
            return result

        if not words:
            return

        padded = [None] + list(words) + [None]
        for idx in range(1, len(padded) - 1):
            prev, current, nxt = padded[idx - 1], padded[idx], padded[idx + 1]
            if skip:
                skip = False
                continue

            next_is_numeric = nxt is not None and _NUMERIC_RE.match(nxt)
            has_prefix = current[0] in self.prefixes
            current_without_prefix = current[1:] if has_prefix else current

            if _NUMERIC_RE.match(current_without_prefix):
                # arabic numbers, possibly signed / fractional
                f = _as_fraction(current_without_prefix)
                assert f is not None
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # concatenate decimals / IP-address components
                        value = str(value) + str(current)
                        continue
                    else:
                        yield flush(value)

                prefix = current[0] if has_prefix else prefix
                value = f.numerator if f.denominator == 1 else current_without_prefix

            elif current not in self.words:
                if value is not None:
                    yield flush(value)
                yield flush(current)

            elif current in self.zeros:
                value = str(value or "") + "0"

            elif current in self.ones:
                ones = self.ones[current]
                if value is None:
                    value = ones
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        # "twenty one": replace the trailing zero
                        assert value[-1] == "0"
                        value = value[:-1] + str(ones)
                    else:
                        value = str(value) + str(ones)
                elif ones < 10:
                    value = value + ones if value % 10 == 0 else str(value) + str(ones)
                else:  # eleven .. nineteen
                    value = value + ones if value % 100 == 0 else str(value) + str(ones)

            elif current in self.ones_suffixed:
                ones, suffix = self.ones_suffixed[current]
                if value is None:
                    yield flush(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        assert value[-1] == "0"
                        yield flush(value[:-1] + str(ones) + suffix)
                    else:
                        yield flush(str(value) + str(ones) + suffix)
                elif ones < 10:
                    if value % 10 == 0:
                        yield flush(str(value + ones) + suffix)
                    else:
                        yield flush(str(value) + str(ones) + suffix)
                else:
                    if value % 100 == 0:
                        yield flush(str(value + ones) + suffix)
                    else:
                        yield flush(str(value) + str(ones) + suffix)
                value = None

            elif current in self.tens:
                tens = self.tens[current]
                if value is None:
                    value = tens
                elif isinstance(value, str):
                    value = str(value) + str(tens)
                else:
                    value = value + tens if value % 100 == 0 else str(value) + str(tens)

            elif current in self.tens_suffixed:
                tens, suffix = self.tens_suffixed[current]
                if value is None:
                    yield flush(str(tens) + suffix)
                elif isinstance(value, str):
                    yield flush(str(value) + str(tens) + suffix)
                elif value % 100 == 0:
                    yield flush(str(value + tens) + suffix)
                else:
                    yield flush(str(value) + str(tens) + suffix)

            elif current in self.multipliers:
                multiplier = self.multipliers[current]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = _as_fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield flush(value)
                        value = multiplier
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier

            elif current in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[current]
                if value is None:
                    yield flush(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = _as_fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        yield flush(str(p.numerator) + suffix)
                    else:
                        yield flush(value)
                        yield flush(str(multiplier) + suffix)
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
                    yield flush(str(value) + suffix)
                value = None

            elif current in self.preceding_prefixers:
                # sign prefix applies only when a number follows
                if value is not None:
                    yield flush(value)
                if nxt in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    yield flush(current)

            elif current in self.following_prefixers:
                # currency word becomes a prefix of the preceding number
                if value is not None:
                    prefix = self.following_prefixers[current]
                    yield flush(value)
                else:
                    yield flush(current)

            elif current in self.suffixers:
                if value is not None:
                    suffix = self.suffixers[current]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            yield flush(str(value) + suffix[nxt])
                            skip = True
                        else:
                            yield flush(value)
                            yield flush(current)
                    else:
                        yield flush(str(value) + suffix)
                else:
                    yield flush(current)

            elif current in self.specials:
                if nxt not in self.words and not next_is_numeric:
                    if value is not None:
                        yield flush(value)
                    yield flush(current)
                elif current == "and":
                    # drop "and" inside "one hundred and one"
                    if prev not in self.multipliers:
                        if value is not None:
                            yield flush(value)
                        yield flush(current)
                elif current in ("double", "triple"):
                    if nxt in self.ones or nxt in self.zeros:
                        repeats = 2 if current == "double" else 3
                        ones = self.ones.get(nxt, 0)
                        value = str(value or "") + str(ones) * repeats
                        skip = True
                    else:
                        if value is not None:
                            yield flush(value)
                        yield flush(current)
                elif current == "point":
                    if nxt in self.decimals or next_is_numeric:
                        value = str(value or "") + "."
                else:
                    raise ValueError(f"Unexpected token: {current}")

            else:
                raise ValueError(f"Unexpected token: {current}")

        if value is not None:
            yield flush(value)

    # ---- pre/post passes --------------------------------------------------

    def preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five"
        results = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if len(segment.strip()) == 0:
                continue
            if i == len(segments) - 1:
                results.append(segment)
            else:
                results.append(segment)
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    results.append("point five")
                else:
                    results.append("and a half")
        s = " ".join(results)

        # space at number/letter boundaries, except numeric suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m: Match) -> str:
            try:
                currency, integer, cents = m.group(1), m.group(2), int(m.group(3))
                return f"{currency}{integer}.{cents:02d}"
            except ValueError:
                return m.string

        def extract_cents(m: Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # "$2 and ¢7" -> "$2.07"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)

        # keep "one(s)" spelled out for readability
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(word for word in self.process_words(s.split()) if word is not None)
        return self.postprocess(s)


class EnglishSpellingNormalizer:
    """British -> American spelling map (normalizers/english.json)."""

    def __init__(self):
        mapping_path = os.path.join(os.path.dirname(__file__), "english.json")
        with open(mapping_path) as f:
            self.mapping = json.load(f)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


_CONTRACTIONS = {
    r"\bwon't\b": "will not",
    r"\bcan't\b": "can not",
    r"\blet's\b": "let us",
    r"\bain't\b": "aint",
    r"\by'all\b": "you all",
    r"\bwanna\b": "want to",
    r"\bgotta\b": "got to",
    r"\bgonna\b": "going to",
    r"\bi'ma\b": "i am going to",
    r"\bimma\b": "i am going to",
    r"\bwoulda\b": "would have",
    r"\bcoulda\b": "could have",
    r"\bshoulda\b": "should have",
    r"\bma'am\b": "madam",
    # titles / honorifics
    r"\bmr\b": "mister ",
    r"\bmrs\b": "missus ",
    r"\bst\b": "saint ",
    r"\bdr\b": "doctor ",
    r"\bprof\b": "professor ",
    r"\bcapt\b": "captain ",
    r"\bgov\b": "governor ",
    r"\bald\b": "alderman ",
    r"\bgen\b": "general ",
    r"\bsen\b": "senator ",
    r"\brep\b": "representative ",
    r"\bpres\b": "president ",
    r"\brev\b": "reverend ",
    r"\bhon\b": "honorable ",
    r"\basst\b": "assistant ",
    r"\bassoc\b": "associate ",
    r"\blt\b": "lieutenant ",
    r"\bcol\b": "colonel ",
    r"\bjr\b": "junior ",
    r"\bsr\b": "senior ",
    r"\besq\b": "esquire ",
    # perfect tenses
    r"'d been\b": " had been",
    r"'s been\b": " has been",
    r"'d gone\b": " had gone",
    r"'s gone\b": " has gone",
    r"'d done\b": " had done",  # "'s done" is ambiguous
    r"'s got\b": " has got",
    # general contractions
    r"n't\b": " not",
    r"'re\b": " are",
    r"'s\b": " is",
    r"'d\b": " would",
    r"'ll\b": " will",
    r"'t\b": " not",
    r"'ve\b": " have",
    r"'m\b": " am",
}


class EnglishTextNormalizer:
    def __init__(self):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.replacers = dict(_CONTRACTIONS)
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()

        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # remove words between brackets
        s = re.sub(r"\(([^)]+?)\)", "", s)  # remove words between parenthesis
        s = re.sub(self.ignore_patterns, "", s)
        s = re.sub(r"\s+'", "'", s)  # standardize when there's a space before '

        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # remove commas between digits
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # remove periods not followed by digits
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")  # keep numeric symbols

        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)

        # remove prefix/suffix symbols not adjacent to digits
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)

        s = re.sub(r"\s+", " ", s)
        return s
