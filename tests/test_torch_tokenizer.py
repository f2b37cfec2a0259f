"""The port's pure-Python BPE vs tiktoken (through the JAX package's
tokenizer): identical ids and text on a fixed corpus and on random strings,
and identical special tokens."""

import random

import pytest

from whisper_tpu.tokenizer import get_encoding as jax_encoding
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch.tokenizer import get_encoding, get_tokenizer

CORPUS = [
    "Hello world!",
    " And so, my fellow Americans: ask not what your country can do for you   ",
    "I'm here, you're there; we'll've 'd 'S I'M",
    "Ça va? Très bien. Übermäßig 123 4567 ½ ² 一二三 Ⅻ",
    "日本語のテキスト、中文文本。한국어 텍스트",
    "Привет, мир! Как дела? Ελληνικά κείμενα",
    "مرحبا بالعالم שלום עולם",
    "   leading\n\nnewlines\t\ttabs  \n ",
    "!!!??? ... ---- (((hi))) [[x]] {{y}} <<>> @#$%^&*",
    "♪♪ music ♪ ♫ ♬",
    "a b c　d e f",
    "x" * 60 + " " + "ab" * 30,
    "emoji 😀👍🏽 ok",
    "3.14159, 2,718 and 1e10 007",
    "tab\tend ",
    " ",
    "",
    "don't won't can't",
    "\r\n\r\n  \n",
]


def _random_corpus(n=300, seed=0):
    rng = random.Random(seed)
    pools = [
        range(32, 127), range(0xA0, 0x250), range(0x400, 0x450), range(0x3040, 0x30FF),
        range(0x4E00, 0x4E40), [0x2003, 0x3000, 0x85, 0x1680, 0x2160, 0x2460, 0x0A, 0x09],
    ]  # fmt: skip
    chars = [chr(c) for pool in pools for c in pool]
    return ["".join(rng.choice(chars) for _ in range(rng.randint(1, 40))) for _ in range(n)]


@pytest.mark.parametrize("name", ["multilingual", "gpt2"])
def test_encode_decode_match_tiktoken(name):
    ref, mine = jax_encoding(name), get_encoding(name)
    for text in CORPUS + _random_corpus():
        ids = ref.encode(text)
        assert mine.encode(text) == ids, repr(text)
        assert mine.decode(ids) == ref.decode(ids), repr(text)


def test_decode_with_timestamps_and_specials():
    ref = jax_tokenizer(True, language="en", task="transcribe")
    mine = get_tokenizer(True, language="en", task="transcribe")
    ids = list(ref.sot_sequence) + ref.encode(" hello there") + [ref.timestamp_begin + 54, ref.eot]
    assert mine.decode_with_timestamps(ids) == ref.decode_with_timestamps(ids)
    assert mine.decode(ids) == ref.decode(ids)
    with pytest.raises(ValueError):
        mine.encode("a <|endoftext|> b")


@pytest.mark.parametrize(
    "multilingual, language, task",
    [(True, "en", "transcribe"), (True, "ja", "translate"), (False, None, None)],
)
def test_special_tokens_match(multilingual, language, task):
    ref = jax_tokenizer(multilingual, language=language, task=task)
    mine = get_tokenizer(multilingual, language=language, task=task)
    assert mine.special_tokens == ref.special_tokens
    assert mine.sot_sequence == ref.sot_sequence
    assert mine.sot_sequence_including_notimestamps == ref.sot_sequence_including_notimestamps
    assert mine.non_speech_tokens == ref.non_speech_tokens
    assert sorted(mine.all_language_tokens) == sorted(ref.all_language_tokens)
    assert sorted(mine.all_language_codes) == sorted(ref.all_language_codes)
    for attr in ("eot", "sot", "sot_prev", "sot_lm", "no_speech", "no_timestamps",
                 "timestamp_begin", "transcribe", "translate"):  # fmt: skip
        assert getattr(mine, attr) == getattr(ref, attr), attr


def test_split_to_word_tokens_matches():
    for language in ("en", "ja"):
        ref = jax_tokenizer(True, language=language)
        mine = get_tokenizer(True, language=language)
        ids = ref.encode(" Hello, world! It's 日本語 text.") + [ref.eot]
        assert mine.split_to_word_tokens(ids) == ref.split_to_word_tokens(ids)


SPECIAL_TEXTS = [
    " a literal <|it|> in a transcript",
    "<|endoftext|>",
    " at <|0.00|> then <|startoftranscript|><|en|><|notimestamps|>",
    "<| it |> <|not a token|> <|",
]


@pytest.mark.parametrize("multilingual", [True, False])
@pytest.mark.parametrize("text", SPECIAL_TEXTS)
def test_disallowed_special_matches_tiktoken(multilingual, text):
    """disallowed_special=() encodes special-token strings as ordinary text,
    as tiktoken does; the default refuses them (and only them)."""
    ref = jax_tokenizer(multilingual, language="en", task="transcribe")
    mine = get_tokenizer(multilingual, language="en", task="transcribe")
    ids = mine.encode(text, disallowed_special=())
    assert ids == ref.encode(text, disallowed_special=())
    assert mine.decode(ids) == text
    holds_special = any(s in text for s in ref.encoding.special_tokens_set)
    for tok in (ref, mine):
        if holds_special:
            with pytest.raises(ValueError):
                tok.encode(text)
        else:
            assert tok.encode(text) == ids
    if "<|it|>" in text:  # a named subset refuses its own
        with pytest.raises(ValueError, match="special token"):
            mine.encoding.encode(text, disallowed_special=["<|it|>"])
