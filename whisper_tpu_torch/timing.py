"""Word-level timestamps by DTW over the cross-attention of the alignment
heads: the counterpart of whisper_tpu/timing.py on its default path.

The window's tokens are replayed through the decoder prefill
(`Whisper.alignment_replay`), which returns the token probabilities and the
(tokens, frames) cost matrix: softmax, z-norm, the median filter (the
median_filter kernel on a card) and the head mean. The matrix is negated on
the model's device, the DTW kernel fills its trace table there, and only the
int8 trace comes to the host for the backtrace. Text-index jumps of the path
mark the word boundaries.

The word-merge and duration-clamp helpers are copied from the JAX package
(whisper_tpu/timing.py:189-291), which cites the reference ranges that
specify them.
"""

import warnings
from dataclasses import dataclass
from typing import TYPE_CHECKING, List

import numpy as np

from .audio import HOP_LENGTH, SAMPLE_RATE, TOKENS_PER_SECOND
from .models.graphs import PREFILL_LEN
from .ops.dtw import dtw
from .tokenizer import Tokenizer

if TYPE_CHECKING:
    from .models.whisper import Whisper


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def find_alignment(
    model: "Whisper",
    tokenizer: Tokenizer,
    text_tokens: List[int],
    num_frames: int,
    ck,
    cv,
    *,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
) -> List[WordTiming]:
    if len(text_tokens) == 0:
        return []

    tokens = [*tokenizer.sot_sequence, tokenizer.no_timestamps, *text_tokens, tokenizer.eot]
    if len(tokens) > PREFILL_LEN:
        warnings.warn(
            f"alignment sequence of {len(tokens)} tokens exceeds the "
            f"{PREFILL_LEN}-token replay window; truncating"
        )
        text_tokens = text_tokens[: PREFILL_LEN - len(tokenizer.sot_sequence) - 2]
        tokens = [*tokenizer.sot_sequence, tokenizer.no_timestamps, *text_tokens, tokenizer.eot]

    n = len(tokens)
    sot_len = len(tokenizer.sot_sequence)
    # row_ids[i] = the token whose probability row i reports
    row_ids = np.zeros(n, dtype=np.int64)
    row_ids[sot_len : sot_len + len(text_tokens)] = text_tokens

    probs, matrix = model.alignment_replay(
        np.asarray([tokens], dtype=np.int64), n, ck, cv, row_ids, num_frames, tokenizer.eot,
        qk_scale=qk_scale, medfilt_width=medfilt_width,
    )  # fmt: skip
    text_token_probs = probs[sot_len : sot_len + len(text_tokens)].tolist()
    text_indices, time_indices = dtw((-matrix[sot_len : n - 1, : num_frames // 2]).contiguous())

    words, word_tokens = tokenizer.split_to_word_tokens(text_tokens + [tokenizer.eot])
    if len(word_tokens) <= 1:
        # a single EOT "word" produces float indices downstream; bail out
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        np.mean(text_token_probs[i:j]) for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]

    return [
        WordTiming(word, tokens, start, end, probability)
        for word, tokens, start, end, probability in zip(
            words, word_tokens, start_times, end_times, word_probabilities
        )
    ]


def _absorb(donor: WordTiming, keeper: WordTiming, donor_first: bool) -> None:
    """Fold `donor`'s text and tokens into `keeper` and blank the donor;
    blanked entries keep their slot so that add_word_timestamps still walks
    the original alignment."""
    if donor_first:
        keeper.word = donor.word + keeper.word
        keeper.tokens = donor.tokens + keeper.tokens
    else:
        keeper.word = keeper.word + donor.word
        keeper.tokens = keeper.tokens + donor.tokens
    donor.word = ""
    donor.tokens = []


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str):
    """Attach punctuation 'words' to their neighbours: opening marks (a
    leading-space word in `prepended`) fold into the word after them;
    closing marks (in `appended`, when the word before does not end in a
    space) fold into the word before."""
    # right to left: each opening mark joins the nearest surviving follower
    anchor = len(alignment) - 1
    for k in range(len(alignment) - 2, -1, -1):
        cand = alignment[k]
        if cand.word.startswith(" ") and cand.word.strip() in prepended:
            _absorb(cand, alignment[anchor], donor_first=True)
        else:
            anchor = k

    # left to right: each closing mark joins the nearest surviving leader
    anchor = 0
    for k in range(1, len(alignment)):
        cand = alignment[k]
        if not alignment[anchor].word.endswith(" ") and cand.word in appended:
            _absorb(cand, alignment[anchor], donor_first=False)
        else:
            anchor = k


_SENTENCE_MARKS = ".。!！?？"


def _typical_and_cap_durations(alignment: List[WordTiming]) -> tuple:
    """(typical_s, cap_s, have_spans): the median nonzero word span clipped
    to 0.7 s, and twice that, the span the clamps treat as too long."""
    spans = np.array([w.end - w.start for w in alignment])
    spans = spans[spans.nonzero()]
    typical_s = float(np.median(spans)) if len(spans) else 0.0
    typical_s = min(0.7, typical_s)
    return typical_s, 2 * typical_s, len(spans) > 0


def _clamp_at_sentence_marks(alignment: List[WordTiming], cap_s: float) -> None:
    """An overlong word at a sentence boundary is clipped to the cap: a long
    sentence mark shrinks forward from its start, a long word right after
    one shrinks backward from its end."""
    for k in range(1, len(alignment)):
        w = alignment[k]
        if w.end - w.start <= cap_s:
            continue
        if w.word in _SENTENCE_MARKS:
            w.end = w.start + cap_s
        elif alignment[k - 1].word in _SENTENCE_MARKS:
            w.start = w.end - cap_s


def _clamp_after_pause(
    words: List[dict], pause_started: float, typical_s: float, cap_s: float
) -> None:
    """A segment's first word does not stretch back across a long pause:
    when the gap since the last speech exceeds 4x the typical span and the
    opening word (or pair) is overlong, its start is pulled in, after
    rebalancing against an overlong second word."""
    opener = words[0]
    if opener["end"] - pause_started <= typical_s * 4:
        return
    pair_overlong = len(words) > 1 and words[1]["end"] - opener["start"] > cap_s * 2
    if not (opener["end"] - opener["start"] > cap_s or pair_overlong):
        return
    if len(words) > 1 and words[1]["end"] - words[1]["start"] > cap_s:
        split = max(words[1]["end"] / 2, words[1]["end"] - cap_s)
        opener["end"] = words[1]["start"] = split
    opener["start"] = max(0, opener["end"] - cap_s)


def _snap_segment_edges(segment: dict, words: List[dict], typical_s: float) -> None:
    """Reconcile the edge words' times with the segment's timestamp-token
    times: keep the segment's time when the edge word overshoots it by more
    than half a second, otherwise move the segment's time onto the word."""
    opener, closer = words[0], words[-1]
    if segment["start"] < opener["end"] and segment["start"] - 0.5 > opener["start"]:
        opener["start"] = max(0, min(opener["end"] - typical_s, segment["start"]))
    else:
        segment["start"] = opener["start"]
    if segment["end"] > closer["start"] and segment["end"] + 0.5 < closer["end"]:
        closer["end"] = max(closer["start"] + typical_s, segment["end"])
    else:
        segment["end"] = closer["end"]


def add_word_timestamps(
    *,
    segments: List[dict],
    model: "Whisper",
    tokenizer: Tokenizer,
    num_frames: int,
    ck,
    cv,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float,
    **kwargs,
):
    """Give each segment of one window its "words" (word, start, end,
    probability), and move the segments' edges onto them."""
    if len(segments) == 0:
        return

    spoken_per_segment = [[t for t in seg["tokens"] if t < tokenizer.eot] for seg in segments]
    alignment = find_alignment(
        model, tokenizer, [t for seg in spoken_per_segment for t in seg], num_frames, ck, cv,
        **kwargs,
    )  # fmt: skip

    typical_s, cap_s, have_spans = _typical_and_cap_durations(alignment)
    if have_spans:
        _clamp_at_sentence_marks(alignment, cap_s)
    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    window_t0 = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    cursor = 0  # alignment entries consumed so far

    for segment, spoken in zip(segments, spoken_per_segment):
        consumed = 0
        words: List[dict] = []
        # hand each segment exactly its own tokens' worth of alignment
        # entries; punctuation-blanked entries spend tokens but emit nothing
        while cursor < len(alignment) and consumed < len(spoken):
            entry = alignment[cursor]
            if entry.word:
                words.append(
                    dict(
                        word=entry.word,
                        start=round(window_t0 + entry.start, 2),
                        end=round(window_t0 + entry.end, 2),
                        probability=entry.probability,
                    )
                )
            consumed += len(entry.tokens)
            cursor += 1

        if words:
            _clamp_after_pause(words, last_speech_timestamp, typical_s, cap_s)
            _snap_segment_edges(segment, words, typical_s)
            last_speech_timestamp = segment["end"]

        segment["words"] = words
