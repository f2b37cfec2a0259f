"""Long-form transcription: the counterpart of whisper_tpu/transcribe.py.

One mel for the whole file plus 30 s of zero padding, 30-second windows
advanced by decoded timestamp tokens, a temperature-fallback ladder gated on
compression ratio and average log-probability, the no-speech gate, prompt
conditioning with `condition_on_previous_text` / `carry_initial_prompt`,
`clip_timestamps`, and the sub-second tail discard. On a CUDA model the mel
is computed on the card and windows are sliced there; on the CPU the host
numpy mel is used, as the JAX package does off its accelerator.

With `word_timestamps`, each window's segments get their words
(timing.add_word_timestamps), the next window starts at the last word's end,
and `hallucination_silence_threshold` turns on the silence and anomaly
heuristics that skip hallucinated text over silence.
"""

import warnings
from typing import TYPE_CHECKING, List, Optional, Tuple, Union

import numpy as np

from .audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    log_mel_spectrogram,
    pad_or_trim,
)
from .decoding import DecodingOptions, DecodingResult
from .timing import add_word_timestamps
from .tokenizer import LANGUAGES, get_tokenizer
from .utils import exact_div, format_timestamp, get_end, make_safe

if TYPE_CHECKING:
    from .models.whisper import Whisper

_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"

# anomaly-score constants (copied from whisper_tpu/transcribe.py:49-58): a
# word scores for being improbable, too brief or too drawn out
_ANOMALY_MIN_PROB = 0.15
_ANOMALY_SHORT_S = 0.133
_ANOMALY_SHORT_RATE = 15.0
_ANOMALY_LONG_S = 2.0
_ANOMALY_SCORE_LIMIT = 3.0
_ANOMALY_HEAD_WORDS = 8


def _word_anomaly_score(word: dict) -> float:
    """Penalty for one word: improbable, too brief, or too drawn out."""
    length_s = word["end"] - word["start"]
    penalty = 1.0 if word.get("probability", 0.0) < _ANOMALY_MIN_PROB else 0.0
    if length_s < _ANOMALY_SHORT_S:
        penalty += _ANOMALY_SHORT_RATE * (_ANOMALY_SHORT_S - length_s)
    if length_s > _ANOMALY_LONG_S:
        penalty += length_s - _ANOMALY_LONG_S
    return penalty


def _is_segment_anomaly(segment: Optional[dict]) -> bool:
    """A segment is anomalous when its leading non-punctuation words score
    past the absolute limit or average about one penalty point a word."""
    if segment is None or not segment["words"]:
        return False
    scored = [w for w in segment["words"] if w["word"] not in _PUNCTUATION]
    scored = scored[:_ANOMALY_HEAD_WORDS]
    total = sum(_word_anomaly_score(w) for w in scored)
    return total >= _ANOMALY_SCORE_LIMIT or total + 0.01 >= len(scored)


def _next_words_segment(segments: List[dict]) -> Optional[dict]:
    return next((s for s in segments if s["words"]), None)


def segments_from_tokens(
    *, tokens, tokenizer, result, seek, segment_size, time_offset, time_precision,
    input_stride, make_segment,
) -> Tuple[List[dict], int, bool]:  # fmt: skip
    """Slice a window's tokens into segments at timestamp pairs and compute
    the next seek (copied from the JAX package). Returns (segments,
    new_seek, single_timestamp_ending)."""
    segments: List[dict] = []
    is_ts = tokens >= tokenizer.timestamp_begin
    lone_final_ts = bool(len(is_ts) >= 2 and not is_ts[-2] and is_ts[-1])

    def ts_seconds(token) -> float:
        return (int(token) - tokenizer.timestamp_begin) * time_precision

    pair_ends = (np.flatnonzero(is_ts[:-1] & is_ts[1:]) + 1).tolist()
    if pair_ends:
        if lone_final_ts:
            pair_ends = pair_ends + [len(tokens)]
        bounds = [0] + pair_ends
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            piece = tokens[lo:hi]
            segments.append(
                make_segment(
                    start=time_offset + ts_seconds(piece[0]),
                    end=time_offset + ts_seconds(piece[-1]),
                    tokens=piece,
                    result=result,
                )
            )
        if lone_final_ts:
            seek += segment_size
        else:
            final_ts = int(tokens[bounds[-1] - 1]) - tokenizer.timestamp_begin
            seek += final_ts * input_stride
    else:
        span_s = segment_size * 0.01  # 10 ms mel frames
        ts_tokens = tokens[np.flatnonzero(is_ts)]
        if len(ts_tokens) and int(ts_tokens[-1]) != tokenizer.timestamp_begin:
            span_s = ts_seconds(ts_tokens[-1])
        segments.append(
            make_segment(
                start=time_offset, end=time_offset + span_s, tokens=tokens, result=result
            )
        )
        seek += segment_size

    return segments, seek, lone_final_ts


def segment_builder(tokenizer, seek: int):
    def make_segment(*, start: float, end: float, tokens, result: DecodingResult):
        tokens = [int(t) for t in tokens]
        spoken = [t for t in tokens if t < tokenizer.eot]
        return dict(
            seek=seek,
            start=start,
            end=end,
            text=tokenizer.decode(spoken),
            tokens=tokens,
            temperature=result.temperature,
            avg_logprob=result.avg_logprob,
            compression_ratio=result.compression_ratio,
            no_speech_prob=result.no_speech_prob,
        )

    return make_segment


def _quality_gates_failed(
    result: DecodingResult,
    compression_ratio_threshold: Optional[float],
    logprob_threshold: Optional[float],
    no_speech_threshold: Optional[float],
) -> bool:
    """Retry at a higher temperature? Repetitive text or a low average
    log-probability fails, unless the window also looks silent."""
    too_repetitive = (
        compression_ratio_threshold is not None
        and result.compression_ratio > compression_ratio_threshold
    )
    too_unlikely = logprob_threshold is not None and result.avg_logprob < logprob_threshold
    looks_silent = (
        no_speech_threshold is not None
        and result.no_speech_prob > no_speech_threshold
        and too_unlikely
    )
    if looks_silent:
        return False
    return too_repetitive or too_unlikely


def _silence_skip_pass(
    *,
    window_segments: List[dict],
    seek: int,
    seek_before: int,
    window_frames: int,
    window_t0: float,
    window_t1: float,
    window_seconds: float,
    content_frames: int,
    content_duration: float,
    threshold: float,
    lone_final_ts: bool,
    hal_last_end: float,
) -> Tuple[int, bool]:
    """The hallucination/silence seek heuristics (copied from
    whisper_tpu/transcribe.py:217-286), applied once the words exist. May
    trim `window_segments` in place. Returns (seek, restart_window): with
    restart_window the caller decodes again from the returned seek and
    emits nothing (the leading-silence skip)."""
    # trailing silence: if speech ended well before the window does, resume
    # right after it; otherwise consume the window as decoded
    if not lone_final_ts:
        spoken_until = get_end(window_segments)
        if spoken_until is not None and spoken_until > window_t0:
            if window_t1 - spoken_until > threshold:
                seek = round(spoken_until * FRAMES_PER_SECOND)
            else:
                seek = seek_before + window_frames

    # leading silence: an anomalous first segment after a gap is likely a
    # hallucination over silence; jump the gap and decode again
    opener = _next_words_segment(window_segments)
    if opener is not None and _is_segment_anomaly(opener):
        gap_s = opener["start"] - window_t0
        if gap_s > threshold:
            return seek_before + round(gap_s * FRAMES_PER_SECOND), True

    # interior: drop an anomalous segment that silence (or more anomalies)
    # surrounds, and resume just before it
    for idx, seg in enumerate(window_segments):
        if not seg["words"]:
            continue
        if _is_segment_anomaly(seg):
            follower = _next_words_segment(window_segments[idx + 1 :])
            follower_start = (
                follower["words"][0]["start"]
                if follower is not None
                else window_t0 + window_seconds
            )
            quiet_before = (
                seg["start"] - hal_last_end > threshold
                or seg["start"] < threshold
                or seg["start"] - window_t0 < 2.0
            )
            quiet_after = (
                follower_start - seg["end"] > threshold
                or _is_segment_anomaly(follower)
                or window_t1 - seg["end"] < 2.0
            )
            if quiet_before and quiet_after:
                seek = round(max(window_t0 + 1, seg["start"]) * FRAMES_PER_SECOND)
                if content_duration - seg["end"] < threshold:
                    seek = content_frames
                del window_segments[idx:]
                break
        hal_last_end = seg["end"]
    return seek, False


def transcribe(
    model: "Whisper",
    audio: Union[str, np.ndarray],
    *,
    verbose: Optional[bool] = None,
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    carry_initial_prompt: bool = False,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    clip_timestamps: Union[str, List[float]] = "0",
    hallucination_silence_threshold: Optional[float] = None,
    **decode_options,
) -> dict:
    """Transcribe audio (path or 16 kHz waveform). Returns a dict with
    "text", "segments" (with "words" when word_timestamps=True) and
    "language". hallucination_silence_threshold takes effect only with
    word_timestamps."""
    if isinstance(audio, str):
        audio = load_audio(audio)
    audio = np.asarray(audio, dtype=np.float32)

    if model.device.type == "cuda":
        from .ops.stft import device_mel_full, device_mel_window

        mel, content_frames = device_mel_full(audio, model.dims.n_mels, model.device)

        def mel_window(seek: int, window_frames: int):
            return device_mel_window(mel, seek, window_frames)

    else:
        mel = log_mel_spectrogram(audio, model.dims.n_mels, padding=N_SAMPLES)
        content_frames = mel.shape[-1] - N_FRAMES

        def mel_window(seek: int, window_frames: int):
            sliced = mel[:, seek : seek + window_frames]
            return pad_or_trim(sliced, N_FRAMES).astype(np.float32)

    content_duration = float(content_frames * HOP_LENGTH / SAMPLE_RATE)

    if decode_options.get("language", None) is None:
        if not model.is_multilingual:
            decode_options["language"] = "en"
        else:
            if verbose:
                print(
                    "Detecting language using up to the first 30 seconds. "
                    "Use `--language` to specify the language"
                )
            _, lang_probs = model.detect_language(mel_window(0, N_FRAMES))
            decode_options["language"] = max(lang_probs, key=lang_probs.get)
            if verbose is not None:
                print(f"Detected language: {LANGUAGES[decode_options['language']].title()}")

    language: str = decode_options["language"]
    task: str = decode_options.get("task", "transcribe")
    tokenizer = get_tokenizer(
        model.is_multilingual, num_languages=model.num_languages, language=language, task=task
    )

    # "start[,end[,start,end...]]" -> [(start_frame, end_frame)]; an
    # unpaired final start runs to the end of the audio
    if isinstance(clip_timestamps, str):
        clip_timestamps = [
            float(t) for t in (clip_timestamps.split(",") if clip_timestamps else [])
        ]
    clip_frames = [round(t * FRAMES_PER_SECOND) for t in clip_timestamps] or [0]
    if len(clip_frames) % 2:
        clip_frames = clip_frames + [content_frames]
    seek_clips: List[Tuple[int, int]] = list(zip(clip_frames[0::2], clip_frames[1::2]))

    if word_timestamps and task == "translate":
        warnings.warn("Word-level timestamps on translations may not be reliable.")

    ladder = [temperature] if isinstance(temperature, (int, float)) else temperature

    def decode_with_fallback(window_features) -> DecodingResult:
        result = None
        for temp in ladder:
            attempt = dict(decode_options, temperature=temp)
            if temp > 0:  # sampling replaces beam search entirely
                attempt.pop("beam_size", None)
                attempt.pop("patience", None)
            else:
                attempt.pop("best_of", None)
            result = model.decode(window_features, DecodingOptions(**attempt))
            if not _quality_gates_failed(
                result, compression_ratio_threshold, logprob_threshold, no_speech_threshold
            ):
                break
        return result

    clip_idx = 0
    seek = seek_clips[clip_idx][0]
    input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)  # mel frames / token: 2
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02 s per token
    all_tokens: List[int] = []
    all_segments: List[dict] = []
    prompt_reset_since = 0

    prompt_budget = model.dims.n_text_ctx // 2 - 1
    initial_prompt_tokens: List[int] = []
    if initial_prompt is not None:
        initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
        all_tokens.extend(initial_prompt_tokens)
        prompt_budget -= len(initial_prompt_tokens)

    last_speech_timestamp = 0.0
    while clip_idx < len(seek_clips):
        clip_start, clip_end = seek_clips[clip_idx]
        seek = max(seek, clip_start)
        if seek >= clip_end:
            clip_idx += 1
            if clip_idx < len(seek_clips):
                seek = seek_clips[clip_idx][0]
            continue
        window_t0 = float(seek * HOP_LENGTH / SAMPLE_RATE)
        window_t1 = float((seek + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE)
        window_frames = min(N_FRAMES, content_frames - seek, clip_end - seek)
        window_seconds = window_frames * HOP_LENGTH / SAMPLE_RATE
        window_features = mel_window(seek, window_frames)

        # padding a sub-second tail out to 30 s causes hallucinations
        if window_seconds < 1.0:
            clip_idx += 1
            continue

        if carry_initial_prompt:
            skip = max(len(initial_prompt_tokens), prompt_reset_since)
            carried = all_tokens[skip:][-prompt_budget:]
            decode_options["prompt"] = initial_prompt_tokens + carried
        else:
            decode_options["prompt"] = all_tokens[prompt_reset_since:]

        result: DecodingResult = decode_with_fallback(window_features)
        tokens = np.array(result.tokens)

        if no_speech_threshold is not None:
            # confident no-speech skips the window, unless the text itself
            # scores confidently
            gated = result.no_speech_prob > no_speech_threshold
            if logprob_threshold is not None and result.avg_logprob > logprob_threshold:
                gated = False
            if gated:
                seek += window_frames
                continue

        seek_before = seek
        window_segments, seek, lone_final_ts = segments_from_tokens(
            tokens=tokens,
            tokenizer=tokenizer,
            result=result,
            seek=seek,
            segment_size=window_frames,
            time_offset=window_t0,
            time_precision=time_precision,
            input_stride=input_stride,
            make_segment=segment_builder(tokenizer, seek),
        )

        if word_timestamps:
            # the replay attends to the window's audio features
            ck, cv = model.cross_kv_untimed(result.audio_features[None])
            add_word_timestamps(
                segments=window_segments,
                model=model,
                tokenizer=tokenizer,
                num_frames=window_frames,
                ck=ck,
                cv=cv,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                last_speech_timestamp=last_speech_timestamp,
            )

            # word-end seek: trust the words over the window's size when the
            # decode did not end on a lone timestamp
            if not lone_final_ts:
                spoken_until = get_end(window_segments)
                if spoken_until is not None and spoken_until > window_t0:
                    seek = round(spoken_until * FRAMES_PER_SECOND)

            if hallucination_silence_threshold is not None:
                seek, restart_window = _silence_skip_pass(
                    window_segments=window_segments,
                    seek=seek,
                    seek_before=seek_before,
                    window_frames=window_frames,
                    window_t0=window_t0,
                    window_t1=window_t1,
                    window_seconds=window_seconds,
                    content_frames=content_frames,
                    content_duration=content_duration,
                    threshold=hallucination_silence_threshold,
                    lone_final_ts=lone_final_ts,
                    hal_last_end=last_speech_timestamp,
                )
                if restart_window:
                    continue

            spoken_until = get_end(window_segments)
            if spoken_until is not None:
                last_speech_timestamp = spoken_until

        if verbose:
            for seg in window_segments:
                stamp = (
                    f"[{format_timestamp(seg['start'])} --> "
                    f"{format_timestamp(seg['end'])}] {seg['text']}"
                )
                print(make_safe(stamp))

        # blank out instantaneous or textless segments
        for seg in window_segments:
            if seg["start"] == seg["end"] or seg["text"].strip() == "":
                seg["text"] = ""
                seg["tokens"] = []
                seg["words"] = []

        all_segments.extend(
            {"id": i, **seg} for i, seg in enumerate(window_segments, start=len(all_segments))
        )
        all_tokens.extend(t for seg in window_segments for t in seg["tokens"])

        if not condition_on_previous_text or result.temperature > 0.5:
            prompt_reset_since = len(all_tokens)

    return dict(
        text=tokenizer.decode(all_tokens[len(initial_prompt_tokens) :]),
        segments=all_segments,
        language=language,
    )
