"""Whisper tokenizer: a pure-Python byte-level BPE over the tiktoken rank files.

The token space is the one whisper_tpu/tokenizer.py builds with tiktoken:
GPT-2 byte-level BPE ranks (whisper_tpu/assets/{gpt2,multilingual}.tiktoken,
read by path), then the special tokens <|endoftext|>, <|startoftranscript|>,
the language tokens, task tokens, <|startoflm|>, <|startofprev|>,
<|nospeech|>, <|notimestamps|> and the 1501 timestamp tokens. The language
table and the non-speech list are copied from there.

tiktoken and the `regex` module are not available everywhere the port runs,
so the pre-tokenizer pattern
    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+
is matched by a hand-written scanner: \\p{L} is str.isalpha() (exactly the L*
categories), \\p{N} the N* Unicode categories, \\s the Unicode White_Space set.
"""

import base64
import os
import string
import unicodedata
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Collection, Dict, List, Optional, Tuple, Union

ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "whisper_tpu", "assets"
)

# fmt: off
_LANGUAGE_LIST = [
    ("en", "english"), ("zh", "chinese"), ("de", "german"), ("es", "spanish"),
    ("ru", "russian"), ("ko", "korean"), ("fr", "french"), ("ja", "japanese"),
    ("pt", "portuguese"), ("tr", "turkish"), ("pl", "polish"), ("ca", "catalan"),
    ("nl", "dutch"), ("ar", "arabic"), ("sv", "swedish"), ("it", "italian"),
    ("id", "indonesian"), ("hi", "hindi"), ("fi", "finnish"), ("vi", "vietnamese"),
    ("he", "hebrew"), ("uk", "ukrainian"), ("el", "greek"), ("ms", "malay"),
    ("cs", "czech"), ("ro", "romanian"), ("da", "danish"), ("hu", "hungarian"),
    ("ta", "tamil"), ("no", "norwegian"), ("th", "thai"), ("ur", "urdu"),
    ("hr", "croatian"), ("bg", "bulgarian"), ("lt", "lithuanian"), ("la", "latin"),
    ("mi", "maori"), ("ml", "malayalam"), ("cy", "welsh"), ("sk", "slovak"),
    ("te", "telugu"), ("fa", "persian"), ("lv", "latvian"), ("bn", "bengali"),
    ("sr", "serbian"), ("az", "azerbaijani"), ("sl", "slovenian"), ("kn", "kannada"),
    ("et", "estonian"), ("mk", "macedonian"), ("br", "breton"), ("eu", "basque"),
    ("is", "icelandic"), ("hy", "armenian"), ("ne", "nepali"), ("mn", "mongolian"),
    ("bs", "bosnian"), ("kk", "kazakh"), ("sq", "albanian"), ("sw", "swahili"),
    ("gl", "galician"), ("mr", "marathi"), ("pa", "punjabi"), ("si", "sinhala"),
    ("km", "khmer"), ("sn", "shona"), ("yo", "yoruba"), ("so", "somali"),
    ("af", "afrikaans"), ("oc", "occitan"), ("ka", "georgian"), ("be", "belarusian"),
    ("tg", "tajik"), ("sd", "sindhi"), ("gu", "gujarati"), ("am", "amharic"),
    ("yi", "yiddish"), ("lo", "lao"), ("uz", "uzbek"), ("fo", "faroese"),
    ("ht", "haitian creole"), ("ps", "pashto"), ("tk", "turkmen"), ("nn", "nynorsk"),
    ("mt", "maltese"), ("sa", "sanskrit"), ("lb", "luxembourgish"), ("my", "myanmar"),
    ("bo", "tibetan"), ("tl", "tagalog"), ("mg", "malagasy"), ("as", "assamese"),
    ("tt", "tatar"), ("haw", "hawaiian"), ("ln", "lingala"), ("ha", "hausa"),
    ("ba", "bashkir"), ("jw", "javanese"), ("su", "sundanese"), ("yue", "cantonese"),
]

_LANGUAGE_ALIASES = {
    "burmese": "my", "valencian": "ca", "flemish": "nl", "haitian": "ht",
    "letzeburgesch": "lb", "pushto": "ps", "panjabi": "pa", "moldavian": "ro",
    "moldovan": "ro", "sinhalese": "si", "castilian": "es", "mandarin": "zh",
}
# fmt: on

LANGUAGES: Dict[str, str] = dict(_LANGUAGE_LIST)
TO_LANGUAGE_CODE: Dict[str, str] = {
    **{name: code for code, name in _LANGUAGE_LIST},
    **_LANGUAGE_ALIASES,
}

_NO_SPACE_LANGUAGES = {"zh", "ja", "th", "lo", "my", "yue"}

# the Unicode White_Space property (what \s matches in tiktoken's regex engine)
_WHITESPACE = frozenset(
    chr(c)
    for c in [
        *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
        0x2028, 0x2029, 0x202F, 0x205F, 0x3000,
    ]
)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_letter(c: str) -> bool:
    return c.isalpha()


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    return not (c in _WHITESPACE or c.isalpha() or _is_number(c))


def _run(text: str, i: int, pred) -> int:
    n = len(text)
    while i < n and pred(text[i]):
        i += 1
    return i


def pretokenize(text: str) -> List[str]:
    """Split `text` into the pieces tiktoken's pattern would match."""
    pieces = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        end = 0
        if c == "'":
            for con in _CONTRACTIONS:
                if text.startswith(con, i):
                    end = i + len(con)
                    break
        if not end:
            # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+' in that order
            start = i + 1 if c == " " and i + 1 < n else i
            for pred in (_is_letter, _is_number, _is_other):
                if pred(text[start]):
                    end = _run(text, start, pred)
                    break
        if not end:
            # whitespace: '\s+(?!\S)' backs off one char before a non-space,
            # else '\s+' takes the whole run
            run_end = _run(text, i, lambda ch: ch in _WHITESPACE)
            if run_end < n and run_end - i > 1:
                end = run_end - 1
            else:
                end = run_end
        pieces.append(text[i:end])
        i = end
    return pieces


def _byte_pair_merge(piece: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """tiktoken's merge: repeatedly join the adjacent pair of lowest rank
    (leftmost on ties) until no pair is in the table."""
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best, best_rank = -1, None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best, best_rank = i, r
        if best < 0:
            break
        parts[best : best + 2] = [parts[best] + parts[best + 1]]
    return [ranks[p] for p in parts]


class Encoding:
    """The subset of tiktoken.Encoding the tokenizer uses."""

    def __init__(self, name: str, ranks: Dict[bytes, int], special_tokens: Dict[str, int]):
        self.name = name
        self._ranks = ranks
        self._special = special_tokens
        self._decoder: Dict[int, bytes] = {r: b for b, r in ranks.items()}
        self._decoder.update({r: s.encode("utf-8") for s, r in special_tokens.items()})
        self.n_vocab = len(self._decoder)

    @property
    def special_tokens_set(self):
        return set(self._special)

    @property
    def eot_token(self) -> int:
        return self._special["<|endoftext|>"]

    def encode_single_token(self, token: str) -> int:
        if token in self._special:
            return self._special[token]
        return self._ranks[token.encode("utf-8")]

    def encode(self, text: str, *, disallowed_special: Union[str, Collection[str]] = "all") -> List[int]:
        """tiktoken's encode with no allowed_special: a special-token string
        of `disallowed_special` ("all": every one) in the text raises
        ValueError; any other, all of them with `()`, encodes as ordinary
        text."""
        if disallowed_special == "all":
            disallowed_special = self._special
        if "<|" in text:
            for special in disallowed_special:
                if special in text:
                    raise ValueError(f"text contains the special token {special!r}")
        out: List[int] = []
        for piece in pretokenize(text):
            raw = piece.encode("utf-8")
            rank = self._ranks.get(raw)
            out.extend([rank] if rank is not None else _byte_pair_merge(raw, self._ranks))
        return out

    def decode(self, tokens: List[int]) -> str:
        raw = b"".join(self._decoder[int(t)] for t in tokens)
        return raw.decode("utf-8", errors="replace")


@dataclass
class Tokenizer:
    """Fast access to Whisper's special tokens over an `Encoding`."""

    encoding: Encoding
    num_languages: int
    language: Optional[str] = None
    task: Optional[str] = None
    sot_sequence: Tuple[int, ...] = ()
    special_tokens: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for special in self.encoding.special_tokens_set:
            self.special_tokens[special] = self.encoding.encode_single_token(special)

        sot = self.special_tokens["<|startoftranscript|>"]
        langs = tuple(LANGUAGES.keys())[: self.num_languages]
        seq = [sot]
        if self.language is not None:
            seq.append(sot + 1 + langs.index(self.language))
        if self.task is not None:
            seq.append(self.transcribe if self.task == "transcribe" else self.translate)
        self.sot_sequence = tuple(seq)

    def encode(self, text: str, **kwargs) -> List[int]:
        return self.encoding.encode(text, **kwargs)

    def decode(self, token_ids: List[int]) -> str:
        token_ids = [t for t in token_ids if t < self.timestamp_begin]
        return self.encoding.decode(token_ids)

    def decode_with_timestamps(self, token_ids: List[int]) -> str:
        """Decode, rendering timestamp tokens as e.g. '<|1.08|>'."""
        return self.encoding.decode(token_ids)

    @cached_property
    def eot(self) -> int:
        return self.encoding.eot_token

    @cached_property
    def transcribe(self) -> int:
        return self.special_tokens["<|transcribe|>"]

    @cached_property
    def translate(self) -> int:
        return self.special_tokens["<|translate|>"]

    @cached_property
    def sot(self) -> int:
        return self.special_tokens["<|startoftranscript|>"]

    @cached_property
    def sot_lm(self) -> int:
        return self.special_tokens["<|startoflm|>"]

    @cached_property
    def sot_prev(self) -> int:
        return self.special_tokens["<|startofprev|>"]

    @cached_property
    def no_speech(self) -> int:
        return self.special_tokens["<|nospeech|>"]

    @cached_property
    def no_timestamps(self) -> int:
        return self.special_tokens["<|notimestamps|>"]

    @cached_property
    def timestamp_begin(self) -> int:
        return self.special_tokens["<|0.00|>"]

    @cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("This tokenizer does not have language token configured")
        return self.to_language_token(self.language)

    def to_language_token(self, language: str) -> int:
        token = self.special_tokens.get(f"<|{language}|>")
        if token is None:
            raise KeyError(f"Language {language} not found in tokenizer.")
        return token

    @cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(
            token_id
            for token, token_id in sorted(self.special_tokens.items(), key=lambda kv: kv[1])
            if token.strip("<|>") in LANGUAGES
        )[: self.num_languages]

    @cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(self.decode([t]).strip("<|>") for t in self.all_language_tokens)

    @cached_property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids suppressed to avoid speaker tags / non-speech annotations
        (music notes, bracketed annotations, etc.), keeping basic punctuation."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        # U+2640..U+267F misc symbols share their first UTF-8 bytes, so
        # suppressing the first token of a multi-token encoding is safe
        miscellaneous = set("♩♪♫♬♭♮♯")

        result = {self.encoding.encode(" -")[0], self.encoding.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for tokens in [
                self.encoding.encode(symbol),
                self.encoding.encode(" " + symbol),
            ]:
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])

        return tuple(sorted(result))

    def split_to_word_tokens(self, tokens: List[int]):
        if self.language in _NO_SPACE_LANGUAGES:
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: List[int]):
        """Split where the accumulated tokens decode to valid unicode."""
        decoded_full = self.decode_with_timestamps(tokens)
        replacement_char = "�"

        words: List[str] = []
        word_tokens: List[List[int]] = []
        current_tokens: List[int] = []
        unicode_offset = 0

        for token in tokens:
            current_tokens.append(token)
            decoded = self.decode_with_timestamps(current_tokens)
            if (
                replacement_char not in decoded
                or decoded_full[unicode_offset + decoded.index(replacement_char)]
                == replacement_char
            ):
                words.append(decoded)
                word_tokens.append(current_tokens)
                current_tokens = []
                unicode_offset += len(decoded)

        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: List[int]):
        subwords, subword_tokens_list = self.split_tokens_on_unicode(tokens)
        words: List[str] = []
        word_tokens: List[List[int]] = []

        for subword, subword_tokens in zip(subwords, subword_tokens_list):
            special = subword_tokens[0] >= self.eot
            with_space = subword.startswith(" ")
            punctuation = subword.strip() in string.punctuation
            if special or with_space or punctuation or len(words) == 0:
                words.append(subword)
                word_tokens.append(subword_tokens)
            else:
                words[-1] = words[-1] + subword
                word_tokens[-1].extend(subword_tokens)

        return words, word_tokens


@lru_cache(maxsize=None)
def get_encoding(name: str = "gpt2", num_languages: int = 99) -> Encoding:
    vocab_path = os.path.join(ASSETS, f"{name}.tiktoken")
    with open(vocab_path) as f:
        ranks = {
            base64.b64decode(token): int(rank)
            for token, rank in (line.split() for line in f if line.strip())
        }

    n_vocab = len(ranks)
    specials = [
        "<|endoftext|>",
        "<|startoftranscript|>",
        *[f"<|{lang}|>" for lang in list(LANGUAGES.keys())[:num_languages]],
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
    ]
    special_tokens = {token: n_vocab + i for i, token in enumerate(specials)}
    return Encoding(os.path.basename(vocab_path), ranks, special_tokens)


@lru_cache(maxsize=None)
def get_tokenizer(
    multilingual: bool,
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,  # "transcribe" | "translate" | None
) -> Tokenizer:
    if language is not None:
        language = language.lower()
        if language not in LANGUAGES:
            if language in TO_LANGUAGE_CODE:
                language = TO_LANGUAGE_CODE[language]
            else:
                raise ValueError(f"Unsupported language: {language}")

    if multilingual:
        encoding_name = "multilingual"
        language = language or "en"
        task = task or "transcribe"
    else:
        encoding_name = "gpt2"
        language = None
        task = None

    encoding = get_encoding(name=encoding_name, num_languages=num_languages)
    return Tokenizer(
        encoding=encoding, num_languages=num_languages, language=language, task=task
    )
