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

from typing import List, Optional, Tuple, Union

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


def _apply_window_result(
    model,
    s: _Stream,
    result: DecodingResult,
    *,
    language: str,
    task: str,
    no_speech_threshold,
    logprob_threshold,
    condition_on_previous_text: bool,
    word_timestamps: bool,
    prepend_punctuations: str,
    append_punctuations: str,
    input_stride: int,
    time_precision: float,
):
    """One decoded window applied to its stream: the no-speech skip, the
    segments and the next seek, word timestamps (each aligned window's
    cross-K/V computed again from its audio features, as transcribe() does)
    with the word-end seek, and the prompt bookkeeping."""
    segment_size = min(N_FRAMES, s.content_frames - s.seek)
    time_offset = float(s.seek * HOP_LENGTH / SAMPLE_RATE)
    tokenizer = get_tokenizer(
        model.is_multilingual, num_languages=model.num_languages, language=language, task=task
    )

    if no_speech_threshold is not None:
        should_skip = result.no_speech_prob > no_speech_threshold
        if logprob_threshold is not None and result.avg_logprob > logprob_threshold:
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
        time_precision=time_precision,
        input_stride=input_stride,
        make_segment=segment_builder(tokenizer, s.seek),
    )

    if word_timestamps:
        ck, cv = model.cross_kv(result.audio_features[None])
        add_word_timestamps(
            segments=segments,
            model=model,
            tokenizer=tokenizer,
            num_frames=segment_size,
            ck=ck,
            cv=cv,
            prepend_punctuations=prepend_punctuations,
            append_punctuations=append_punctuations,
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
    if not condition_on_previous_text or result.temperature > 0.5:
        s.prompt_reset_since = len(s.all_tokens)


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
    temperatures = [temperature] if isinstance(temperature, (int, float)) else list(temperature)

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

    def stream_windows(active, seeks, sizes):
        """(len(active), n_mels, N_FRAMES): one window per stream of
        `active`, zero past its size."""
        if device_mels is not None:
            return batched_mel_windows(device_mels[[s.idx for s in active]], seeks, sizes)
        return np.stack(
            [pad_or_trim(s.mel[:, seek : seek + size], N_FRAMES).astype(np.float32)
             for s, seek, size in zip(active, seeks, sizes)]
        )  # fmt: skip

    if language is None:
        # each stream's first full window (no zero mask), as transcribe()
        # detects on mel[:, :N_FRAMES]
        first = stream_windows(streams, [0] * len(streams), [N_FRAMES] * len(streams))
        stream_language = []
        for i in range(len(streams)):
            _, probs = model.detect_language(first[i])
            stream_language.append(max(probs, key=probs.get))
    else:
        stream_language = [language] * len(streams)

    input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE
    bookkeeping = dict(
        task=task,
        no_speech_threshold=no_speech_threshold,
        logprob_threshold=logprob_threshold,
        condition_on_previous_text=condition_on_previous_text,
        word_timestamps=word_timestamps,
        prepend_punctuations=prepend_punctuations,
        append_punctuations=append_punctuations,
        input_stride=input_stride,
        time_precision=time_precision,
    )

    while True:
        active = [s for s in streams if not s.done]
        if not active:
            break
        seeks = [s.seek for s in active]
        sizes = [min(N_FRAMES, s.content_frames - s.seek) for s in active]
        prompts = [
            s.all_tokens[s.prompt_reset_since :] if condition_on_previous_text else [] for s in active
        ]
        mels = stream_windows(active, seeks, sizes)

        lang_groups = {}
        for pos, s in enumerate(active):
            lang_groups.setdefault(stream_language[s.idx], []).append(pos)

        results: List[Optional[DecodingResult]] = [None] * len(active)
        for lang, positions in lang_groups.items():
            first_results = _decode_window_batch(
                model, mels[positions], [prompts[p] for p in positions], lang, temperatures[0],
                task, decode_options,
            )  # fmt: skip
            # the temperature ladder, for the windows that failed only
            for slot, r in zip(positions, first_results):
                for t in temperatures[1:]:
                    if not _quality_gates_failed(
                        r, compression_ratio_threshold, logprob_threshold, no_speech_threshold
                    ):
                        break
                    r = _decode_window_batch(
                        model, mels[slot : slot + 1], [prompts[slot]], lang, t, task, decode_options
                    )[0]
                results[slot] = r

        for s, result in zip(active, results):
            _apply_window_result(model, s, result, language=stream_language[s.idx], **bookkeeping)

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
