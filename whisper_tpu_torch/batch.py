"""Multi-stream transcription: N streams, or the chunks of one long file,
decoded together (the counterpart of whisper_tpu/batch.py).

`transcribe_batch` steps the streams' 30-second windows in lockstep: each
round slices one window per stream and decodes them as one batch, so that
one encoder pass and one decode loop serve every stream. A round whose
streams share a prompt (no conditioning, or the first round) is one call of
the engine at B = N; streams with different prompts decode in one call per
prompt. A stream that fails a quality gate falls back through the
temperature ladder alone, one row at a time. A round holds only the streams
that are not done: the engine runs eagerly, so a batch of another size costs
nothing (the JAX package keeps finished streams as zero windows so that its
compiled batch shape stays fixed).

Per stream the result is transcribe()'s for the options it supports (greedy
or beam, the temperature ladder, conditioning, word timestamps); for
clip_timestamps and the hallucination heuristics use transcribe(). On a
CUDA model the streams' mel is one tensor on the card; on the CPU each
stream has its host numpy mel.
"""

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .audio import HOP_LENGTH, N_FRAMES, N_SAMPLES, SAMPLE_RATE, load_audio, log_mel_spectrogram, pad_or_trim
from .decoding import DecodingOptions, DecodingResult, DecodingTask
from .timing import add_word_timestamps
from .tokenizer import get_tokenizer
from .transcribe import _quality_gates_failed, segment_builder, segments_from_tokens
from .utils import exact_div, get_end


class _Stream:
    def __init__(self, idx: int, mel: Optional[np.ndarray], content_frames: int):
        self.last_speech_timestamp = 0.0
        self.idx = idx
        self.mel = mel  # host mel; None when the streams' mel is on the card
        self.content_frames = content_frames
        self.seek = 0
        self.all_tokens: List[int] = []
        self.all_segments: List[dict] = []
        self.prompt_reset_since = 0

    @property
    def window_frames(self) -> int:
        """Frames of the window at the seek: 30 s, or what is left."""
        return min(N_FRAMES, self.content_frames - self.seek)

    @property
    def done(self) -> bool:
        # a sub-second tail is dropped: padded to 30 s it brings hallucinations
        return self.content_frames - self.seek < SAMPLE_RATE // HOP_LENGTH


def _stream_result(model, s: _Stream, language: str, task: str) -> dict:
    """A finished stream's result, in transcribe()'s schema."""
    tokenizer = get_tokenizer(
        model.is_multilingual, num_languages=model.num_languages, language=language, task=task
    )
    return dict(text=tokenizer.decode(s.all_tokens), segments=s.all_segments, language=language)


def _decode_window_batch(model, mels, prompts, lang: str, t: float, task: str, decode_options):
    """Decode one round's windows at temperature `t`, one DecodingTask per
    distinct prompt, each on the model's loop (the engine unless the
    model's `use_fused_decode` is off)."""
    kwargs = dict(decode_options)
    if t > 0:
        kwargs.pop("beam_size", None)
        kwargs.pop("patience", None)
    else:
        kwargs.pop("best_of", None)
    results: List[Optional[DecodingResult]] = [None] * len(prompts)
    groups = {}
    for i, p in enumerate(prompts):
        groups.setdefault(tuple(p), []).append(i)
    for prompt, idxs in groups.items():
        opts = DecodingOptions(
            language=lang, task=task, temperature=t, prompt=list(prompt) or None, **kwargs
        )
        out = DecodingTask(model, opts).run(mels[idxs])
        for i, r in zip(idxs, out):
            results[i] = r
    return results


class _Rounds:
    """How a round's windows decode and how each result applies to its
    stream, shared by transcribe_batch and the continuous batcher.

    decode(): one group per language, each decoded at the first
    temperature as one _decode_window_batch (one DecodingTask per distinct
    prompt); a window that fails a quality gate falls back through the
    temperature ladder alone, one row at a time. apply(): the no-speech
    skip, the segments and the next seek, word timestamps (each aligned
    window's cross-K/V computed again from its audio features, as
    transcribe() does) with the word-end seek, and the prompt bookkeeping.
    """

    def __init__(
        self,
        model,
        *,
        task: str,
        temperature,
        compression_ratio_threshold: Optional[float],
        logprob_threshold: Optional[float],
        no_speech_threshold: Optional[float],
        condition_on_previous_text: bool,
        word_timestamps: bool,
        prepend_punctuations: str,
        append_punctuations: str,
        decode_options: dict,
    ):
        self.model = model
        self.task = task
        self.temperatures = [temperature] if isinstance(temperature, (int, float)) else list(temperature)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self.condition_on_previous_text = condition_on_previous_text
        self.word_timestamps = word_timestamps
        self.prepend_punctuations = prepend_punctuations
        self.append_punctuations = append_punctuations
        self.decode_options = decode_options
        self.input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)
        self.time_precision = self.input_stride * HOP_LENGTH / SAMPLE_RATE

    def decode(self, streams: List[_Stream], mels, langs: List[str]) -> List[DecodingResult]:
        """The round's results, row for row: `mels` holds one window per
        stream of `streams`, `langs` one language."""
        prompts = [
            s.all_tokens[s.prompt_reset_since :] if self.condition_on_previous_text else [] for s in streams
        ]
        lang_groups: Dict[str, List[int]] = {}
        for row, lang in enumerate(langs):
            lang_groups.setdefault(lang, []).append(row)
        results: List[Optional[DecodingResult]] = [None] * len(streams)
        for lang, rows in lang_groups.items():
            first = _decode_window_batch(
                self.model, mels[rows], [prompts[r] for r in rows], lang, self.temperatures[0],
                self.task, self.decode_options,
            )  # fmt: skip
            # the temperature ladder, for the windows that failed only
            for row, r in zip(rows, first):
                for t in self.temperatures[1:]:
                    if not _quality_gates_failed(
                        r, self.compression_ratio_threshold, self.logprob_threshold,
                        self.no_speech_threshold,
                    ):  # fmt: skip
                        break
                    r = _decode_window_batch(
                        self.model, mels[row : row + 1], [prompts[row]], lang, t, self.task,
                        self.decode_options,
                    )[0]  # fmt: skip
                results[row] = r
        return results

    def apply(self, s: _Stream, result: DecodingResult, language: str):
        """One decoded window applied to its stream."""
        model = self.model
        segment_size = s.window_frames
        time_offset = float(s.seek * HOP_LENGTH / SAMPLE_RATE)
        tokenizer = get_tokenizer(
            model.is_multilingual, num_languages=model.num_languages, language=language, task=self.task
        )

        if self.no_speech_threshold is not None:
            should_skip = result.no_speech_prob > self.no_speech_threshold
            if self.logprob_threshold is not None and result.avg_logprob > self.logprob_threshold:
                should_skip = False
            if should_skip:
                s.seek += segment_size
                return

        segments, s.seek, single_timestamp_ending = segments_from_tokens(
            tokens=np.array(result.tokens),
            tokenizer=tokenizer,
            result=result,
            seek=s.seek,
            segment_size=segment_size,
            time_offset=time_offset,
            time_precision=self.time_precision,
            input_stride=self.input_stride,
            make_segment=segment_builder(tokenizer, s.seek),
        )

        if self.word_timestamps:
            ck, cv = model.cross_kv_untimed(result.audio_features[None])
            add_word_timestamps(
                segments=segments,
                model=model,
                tokenizer=tokenizer,
                num_frames=segment_size,
                ck=ck,
                cv=cv,
                prepend_punctuations=self.prepend_punctuations,
                append_punctuations=self.append_punctuations,
                last_speech_timestamp=s.last_speech_timestamp,
            )
            # resume after the last spoken word unless the window ended on a
            # lone timestamp
            if not single_timestamp_ending:
                last_word_end = get_end(segments)
                if last_word_end is not None and last_word_end > time_offset:
                    s.seek = round(last_word_end * (SAMPLE_RATE // HOP_LENGTH))
            last_word_end = get_end(segments)
            if last_word_end is not None:
                s.last_speech_timestamp = last_word_end

        for segment in segments:
            if segment["start"] == segment["end"] or segment["text"].strip() == "":
                segment["text"] = ""
                segment["tokens"] = []

        s.all_segments.extend({"id": i, **seg} for i, seg in enumerate(segments, start=len(s.all_segments)))
        s.all_tokens.extend(t for seg in segments for t in seg["tokens"])
        if not self.condition_on_previous_text or result.temperature > 0.5:
            s.prompt_reset_since = len(s.all_tokens)


def _host_windows(streams: List[_Stream], sizes: List[int]) -> np.ndarray:
    """(len(streams), n_mels, N_FRAMES) from the streams' host mels: each
    stream's window at its seek, zero past its size."""
    return np.stack(
        [pad_or_trim(s.mel[:, s.seek : s.seek + size], N_FRAMES).astype(np.float32)
         for s, size in zip(streams, sizes)]
    )  # fmt: skip


def transcribe_batch(
    model,
    audios: List[Union[str, np.ndarray]],
    *,
    language: Optional[str] = None,
    task: str = "transcribe",
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'\u201c\u00bf([{-",
    append_punctuations: str = "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001",
    verbose: Optional[bool] = None,
    **decode_options,
) -> List[dict]:
    """Transcribe N audio streams (paths or 16 kHz waveforms) together.
    Returns one result per stream, in transcribe()'s schema.

    `verbose` is accepted so that callers can share one set of keyword
    arguments with transcribe(); the rounds interleave the streams, so
    nothing is printed, and it does not reach DecodingOptions."""
    if language is None:
        language = "en" if not model.is_multilingual else None

    streams = []
    device_mels = None
    if model.device.type == "cuda":
        from .frontend import batched_device_mel, batched_mel_windows

        loaded = [load_audio(a) if isinstance(a, str) else np.asarray(a, np.float32) for a in audios]
        device_mels, content = batched_device_mel(loaded, model.dims.n_mels, model.device)
        streams = [_Stream(i, None, cf) for i, cf in enumerate(content)]
    else:
        for i, audio in enumerate(audios):
            mel = log_mel_spectrogram(audio, model.dims.n_mels, padding=N_SAMPLES)
            streams.append(_Stream(i, mel, mel.shape[-1] - N_FRAMES))

    def stream_windows(active, sizes):
        """(len(active), n_mels, N_FRAMES): one window per stream of
        `active`, at its seek, zero past its size."""
        if device_mels is not None:
            return batched_mel_windows(device_mels[[s.idx for s in active]], [s.seek for s in active], sizes)
        return _host_windows(active, sizes)

    if language is None:
        # each stream's first full window (no zero mask), as transcribe()
        # detects on mel[:, :N_FRAMES]
        first = stream_windows(streams, [N_FRAMES] * len(streams))
        stream_language = []
        for i in range(len(streams)):
            _, probs = model.detect_language(first[i])
            stream_language.append(max(probs, key=probs.get))
    else:
        stream_language = [language] * len(streams)

    rounds = _Rounds(
        model,
        task=task,
        temperature=temperature,
        compression_ratio_threshold=compression_ratio_threshold,
        logprob_threshold=logprob_threshold,
        no_speech_threshold=no_speech_threshold,
        condition_on_previous_text=condition_on_previous_text,
        word_timestamps=word_timestamps,
        prepend_punctuations=prepend_punctuations,
        append_punctuations=append_punctuations,
        decode_options=decode_options,
    )
    while True:
        active = [s for s in streams if not s.done]
        if not active:
            break
        mels = stream_windows(active, [s.window_frames for s in active])
        langs = [stream_language[s.idx] for s in active]
        for s, lang, result in zip(active, langs, rounds.decode(active, mels, langs)):
            rounds.apply(s, result, lang)

    return [_stream_result(model, s, stream_language[s.idx], task) for s in streams]


def transcribe_chunked(
    model, audio: Union[str, np.ndarray], *, chunk_seconds: int = 30, **kwargs
) -> dict:
    """One long audio split at fixed `chunk_seconds` boundaries, the chunks
    decoded together as the streams of one transcribe_batch, the results
    merged with each chunk's time and seek offset. No conditioning crosses
    a boundary (it is off by default in every chunk) and a word can
    straddle one; for the most faithful transcript use transcribe()."""
    if isinstance(audio, str):
        audio = load_audio(audio)
    audio = np.asarray(audio, dtype=np.float32)
    chunk = chunk_seconds * SAMPLE_RATE
    n_chunks = max(1, -(-len(audio) // chunk))
    chunks = [audio[i * chunk : (i + 1) * chunk] for i in range(n_chunks)]

    kwargs.setdefault("condition_on_previous_text", False)
    results = transcribe_batch(model, chunks, **kwargs)

    segments, idx = [], 0
    for i, r in enumerate(results):
        off = i * chunk_seconds
        for seg in r["segments"]:
            seg = dict(seg)
            seg["id"] = idx
            seg["start"] += off
            seg["end"] += off
            seg["seek"] += i * (chunk // HOP_LENGTH)
            segments.append(seg)
            idx += 1
    return dict(
        text="".join(r["text"] for r in results),
        segments=segments,
        language=results[0]["language"] if results else None,
    )
