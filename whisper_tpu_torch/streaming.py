"""Incremental (streaming) transcription: the counterpart of
whisper_tpu/streaming.py.

Audio arrives in chunks of any size, and finished segments come out as soon
as a full 30-second window is available, with transcribe()'s window
semantics (the temperature ladder, the no-speech skip, timestamp-based seek,
prompt conditioning):

    st = StreamingTranscriber(model, language="en")
    for chunk in pcm_chunks:           # float32 @ 16 kHz, any length
        for seg in st.feed(chunk):
            print(seg["text"])
    for seg in st.flush():             # decode the final partial window
        print(seg["text"])

Each window's mel is computed over the undecoded tail only, with a 2-frame
margin that makes its frames those of a whole-stream mel, and consumed
audio is dropped, so a window's cost and the buffer stay O(30 s) however
old the stream is. The floor of the mel's dynamic range follows the
running maximum of every frame fed so far. A stream fed in chunks gives the
segments of transcribe() on the concatenated audio, for every option but
clip_timestamps (absolute file positions, which a live stream does not
have). On a CUDA model the tail mel is computed on the card, as
transcribe()'s is; on the CPU it is the host numpy mel.

`word_timestamps=True` attaches words to FINAL segments through the
replay transcribe() runs, its word-end seek included (each aligned window's
cross-K/V is computed again from its audio features);
`hallucination_silence_threshold` runs the silence pass per finalized
window (see the note in __init__ on causality). `language=None` on a
multilingual model detects on the first finalized window, the window
transcribe(language=None) detects on, and pins it; until then partials
detect per window.

PARTIAL results: with `partial_hop_s` (e.g. 1.0), feed() also returns
advisory segments for the window still open, the available audio padded to
a full window and decoded now. Partials carry `"partial": True`, are
superseded by every later emission for the same region, and never touch
the stream's state (seek, prompt tokens, finished segments), so the final
output stays that of transcribe(). `partial()` runs one such decode on
demand.
"""

from typing import List, Optional

import numpy as np

from .audio import FRAMES_PER_SECOND, HOP_LENGTH, N_FRAMES, N_SAMPLES, SAMPLE_RATE, pad_or_trim
from .decoding import DecodingOptions, DecodingResult
from .ops.stft import log_mel_raw_np, normalize_log_mel
from .timing import add_word_timestamps
from .tokenizer import get_tokenizer
from .transcribe import _quality_gates_failed, _silence_skip_pass, segment_builder, segments_from_tokens
from .utils import exact_div, get_end


class StreamingTranscriber:
    """Stateful incremental transcriber over one audio stream."""

    # STFT windows reach N_FFT / 2 = 200 samples past a frame; waiting for
    # this many extra frames before decoding a window that is not the last,
    # and keeping as many real frames to the left of a cut, makes a tail
    # mel's frames from the cut on equal to the whole-stream mel's
    _LOOKAHEAD_FRAMES = 2

    def __init__(
        self,
        model,
        *,
        language: Optional[str] = None,
        task: str = "transcribe",
        temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        partial_hop_s: Optional[float] = None,
        word_timestamps: bool = False,
        prepend_punctuations: str = "\"'“¿([{-",
        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
        hallucination_silence_threshold: Optional[float] = None,
        verbose: Optional[bool] = None,  # transcribe()'s signature; segments come from feed()/flush()
        **decode_options,
    ):
        if partial_hop_s is not None and partial_hop_s <= 0:
            raise ValueError("partial_hop_s must be positive (or None)")
        self.model = model
        if language is None and not model.is_multilingual:
            language = "en"
        self.language = language  # None: detected on the first final window
        self.task = task
        self.temperatures = [temperature] if isinstance(temperature, (int, float)) else list(temperature)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self.condition_on_previous_text = condition_on_previous_text
        self.word_timestamps = word_timestamps
        self.prepend_punctuations = prepend_punctuations
        self.append_punctuations = append_punctuations
        # active with word_timestamps only, as in transcribe(). transcribe()'s
        # tail rule compares an anomaly's end with the whole file's duration,
        # which a live stream knows only at flush: windows finished earlier
        # treat the audio still to come as unbounded (the same decisions,
        # unless the stream ends within `threshold` seconds of a window
        # boundary that carries a culled trailing anomaly)
        self.hallucination_silence_threshold = hallucination_silence_threshold
        self.decode_options = dict(decode_options)
        self._last_speech_ts = 0.0

        self.tokenizer = None if language is None else self._tokenizer(language)
        self._audio = np.zeros(0, np.float32)
        self._base = 0  # absolute mel frame of self._audio[0]
        self._log_max = -np.inf  # running log-mel max over the whole stream (a host float)
        self._seek = 0  # mel frames consumed (absolute)
        self._all_tokens: List[int] = []
        self._prompt_reset_since = 0
        self._segments: List[dict] = []
        self._input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)
        self._time_precision = self._input_stride * HOP_LENGTH / SAMPLE_RATE
        self._flushed = False
        self.partial_hop_s = partial_hop_s
        # a hop under one frame would mean a partial on every feed()
        self._partial_hop_frames = (
            max(1, int(partial_hop_s * SAMPLE_RATE) // HOP_LENGTH) if partial_hop_s is not None else None
        )
        self._last_partial_frames = 0  # content frames at the last partial

    # ---- internals -----------------------------------------------------------

    def _tokenizer(self, language: str):
        return get_tokenizer(
            self.model.is_multilingual, num_languages=self.model.num_languages,
            language=language, task=self.task,
        )  # fmt: skip

    def _content_frames(self) -> int:
        return self._base + len(self._audio) // HOP_LENGTH

    def _tail_offset(self) -> int:
        """Where the window at `self._seek` starts in the tail mel."""
        return self._seek - max(self._base, self._seek - self._LOOKAHEAD_FRAMES)

    def _tail_mel(self):
        """The normalized mel of the retained tail (+30 s of zeros), from
        absolute frame max(base, seek - lookahead). The floor is anchored to
        the running stream-wide max, as transcribe() floors at the whole
        file's: a window finished before the stream's loudest frame arrives
        uses the max so far, as a live system must. On a CUDA model the mel
        is computed on the card (the max read back as a host float)."""
        start = max(self._base, self._seek - self._LOOKAHEAD_FRAMES)
        cut = self._audio[(start - self._base) * HOP_LENGTH :]
        if self.model.device.type == "cuda":
            from .ops.stft import device_mel_raw, normalize_log_mel_torch

            raw, _ = device_mel_raw(cut, self.model.dims.n_mels, self.model.device)
            self._log_max = max(self._log_max, float(raw.max()))
            return normalize_log_mel_torch(raw, self._log_max)
        raw = log_mel_raw_np(cut, self.model.dims.n_mels, padding=N_SAMPLES)
        self._log_max = max(self._log_max, float(raw.max()))
        return normalize_log_mel(raw, self._log_max)

    def _window_mel(self, avail: int, mel):
        """The window at absolute frame `self._seek`, zero past the
        available frames, and its segment size."""
        off = self._tail_offset()
        segment_size = min(N_FRAMES, avail)
        if self.model.device.type == "cuda":
            from .ops.stft import device_mel_window

            return device_mel_window(mel, off, segment_size), segment_size
        return pad_or_trim(mel[:, off : off + segment_size], N_FRAMES).astype(np.float32), segment_size

    def _detect_window_language(self, mel) -> str:
        """detect_language on the window at seek, built as transcribe()'s
        detection window is: N_FRAMES frames of the zero-PADDED mel, so a
        short window's tail holds frames of silence, not zeros (a decode
        window is zeroed there instead)."""
        off = self._tail_offset()
        _, lang_probs = self.model.detect_language(mel[:, off : off + N_FRAMES])
        return max(lang_probs, key=lang_probs.get)

    def _decode_window(self, mel_window, language=None) -> DecodingResult:
        result = None
        prompt = self._all_tokens[self._prompt_reset_since :] if self.condition_on_previous_text else []
        for t in self.temperatures:
            kwargs = dict(self.decode_options)
            if t > 0:
                kwargs.pop("beam_size", None)
                kwargs.pop("patience", None)
            else:
                kwargs.pop("best_of", None)
            options = DecodingOptions(
                language=language or self.language, task=self.task, temperature=t, prompt=prompt,
                **kwargs,
            )  # fmt: skip
            result = self.model.decode(mel_window, options)
            if not _quality_gates_failed(
                result, self.compression_ratio_threshold, self.logprob_threshold,
                self.no_speech_threshold,
            ):  # fmt: skip
                break
        return result

    def _is_silence(self, result: DecodingResult) -> bool:
        """transcribe()'s no-speech skip: confident no-speech, unless the
        text itself scores confidently."""
        if self.no_speech_threshold is None or result.no_speech_prob <= self.no_speech_threshold:
            return False
        return not (self.logprob_threshold is not None and result.avg_logprob > self.logprob_threshold)

    def _align_words(self, segments: List[dict], result: DecodingResult, segment_size: int) -> None:
        """Words for this window's segments, by transcribe()'s replay over
        the window's cross-K/V, computed again from its audio features."""
        ck, cv = self.model.cross_kv(result.audio_features[None])
        add_word_timestamps(
            segments=segments,
            model=self.model,
            tokenizer=self.tokenizer,
            num_frames=segment_size,
            ck=ck,
            cv=cv,
            prepend_punctuations=self.prepend_punctuations,
            append_punctuations=self.append_punctuations,
            last_speech_timestamp=self._last_speech_ts,
        )

    def _trim_consumed(self) -> None:
        """Drop the audio the decode loop can never look at again: all
        before seek minus the mel margin."""
        keep_from = max(self._base, self._seek - self._LOOKAHEAD_FRAMES)
        if keep_from > self._base:
            self._audio = self._audio[(keep_from - self._base) * HOP_LENGTH :]
            self._base = keep_from

    def _process(self, final: bool) -> List[dict]:
        """Decode as many complete windows as the buffer holds."""
        out: List[dict] = []
        while True:
            content_frames = self._content_frames()
            avail = content_frames - self._seek
            if avail <= 0:
                break
            if avail < N_FRAMES + self._LOOKAHEAD_FRAMES and not final:
                break  # wait for a full window and the mel margin
            if final and avail < SAMPLE_RATE // HOP_LENGTH:
                break  # a sub-second tail padded to 30 s brings hallucinations
            tail_mel = self._tail_mel()  # one STFT for the decode and the detection
            mel_window, segment_size = self._window_mel(avail, tail_mel)
            time_offset = float(self._seek * HOP_LENGTH / SAMPLE_RATE)
            if self.language is None:
                self.language = self._detect_window_language(tail_mel)
                self.tokenizer = self._tokenizer(self.language)

            result = self._decode_window(mel_window)
            if self._is_silence(result):
                self._seek += segment_size
                continue

            seek_before = self._seek
            segments, self._seek, lone_final_ts = segments_from_tokens(
                tokens=np.array(result.tokens),
                tokenizer=self.tokenizer,
                result=result,
                seek=self._seek,
                segment_size=segment_size,
                time_offset=time_offset,
                time_precision=self._time_precision,
                input_stride=self._input_stride,
                make_segment=segment_builder(self.tokenizer, seek_before),
            )
            if self.word_timestamps:
                self._align_words(segments, result, segment_size)
                # word-end seek: trust the words over the window's size when
                # the decode did not end on a lone timestamp
                if not lone_final_ts:
                    spoken_until = get_end(segments)
                    if spoken_until is not None and spoken_until > time_offset:
                        self._seek = round(spoken_until * FRAMES_PER_SECOND)
                if self.hallucination_silence_threshold is not None:
                    # windows before the flush treat the audio still to come
                    # as unbounded (see __init__); at flush the true bounds
                    # apply and the decisions are transcribe()'s
                    if final:
                        cf, cd = content_frames, content_frames * HOP_LENGTH / SAMPLE_RATE
                    else:
                        cf, cd = 1 << 62, float("inf")
                    self._seek, restart_window = _silence_skip_pass(
                        window_segments=segments,
                        seek=self._seek,
                        seek_before=seek_before,
                        window_frames=segment_size,
                        window_t0=time_offset,
                        window_t1=float((seek_before + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE),
                        window_seconds=segment_size * HOP_LENGTH / SAMPLE_RATE,
                        content_frames=cf,
                        content_duration=cd,
                        threshold=self.hallucination_silence_threshold,
                        lone_final_ts=lone_final_ts,
                        hal_last_end=self._last_speech_ts,
                    )
                    if restart_window:
                        continue
                spoken_until = get_end(segments)
                if spoken_until is not None:
                    self._last_speech_ts = spoken_until
            for seg in segments:
                if seg["start"] == seg["end"] or seg["text"].strip() == "":
                    seg["text"] = ""
                    seg["tokens"] = []
                    seg["words"] = []
            numbered = [{"id": i, **seg} for i, seg in enumerate(segments, start=len(self._segments))]
            self._segments.extend(numbered)
            out.extend(numbered)
            self._all_tokens.extend(t for seg in segments for t in seg["tokens"])
            if not self.condition_on_previous_text or result.temperature > 0.5:
                self._prompt_reset_since = len(self._all_tokens)
            if final and self._seek >= content_frames:
                break
        return out

    # ---- public API ------------------------------------------------------------

    def feed(self, audio: np.ndarray) -> List[dict]:
        """Append PCM (float32 mono at 16 kHz); returns the segments that
        became final. With `partial_hop_s`, the list also carries advisory
        segments (`"partial": True`) for the window still open whenever at
        least that much audio arrived since the last partial."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        self._audio = np.concatenate([self._audio, audio])
        out = self._process(final=False)
        self._trim_consumed()
        if self.partial_hop_s is not None:
            content_frames = self._content_frames()
            if (
                content_frames - self._seek > 0
                and content_frames - self._last_partial_frames >= self._partial_hop_frames
            ):
                out.extend(self.partial())
        return out

    def partial(self) -> List[dict]:
        """Decode the window still open now (padded to a full window) and
        return advisory segments flagged `"partial": True`. Reads the
        stream's state and changes none of it."""
        if self._flushed:
            return []
        content_frames = self._content_frames()
        avail = content_frames - self._seek
        # a sub-second open window padded to 30 s invites hallucinations,
        # which transcribe() avoids by dropping such tails: wait for a second
        if avail < SAMPLE_RATE // HOP_LENGTH:
            return []
        self._last_partial_frames = content_frames
        tail_mel = self._tail_mel()
        mel_window, segment_size = self._window_mel(avail, tail_mel)
        # before the language is pinned (first final window), a partial
        # detects on the open window for itself and pins nothing
        language, tokenizer = self.language, self.tokenizer
        if language is None:
            language = self._detect_window_language(tail_mel)
            tokenizer = self._tokenizer(language)
        result = self._decode_window(mel_window, language=language)
        if self._is_silence(result):
            return []
        segments, _, _ = segments_from_tokens(
            tokens=np.array(result.tokens),
            tokenizer=tokenizer,
            result=result,
            seek=self._seek,  # a local copy: self._seek does not move
            segment_size=segment_size,
            time_offset=float(self._seek * HOP_LENGTH / SAMPLE_RATE),
            time_precision=self._time_precision,
            input_stride=self._input_stride,
            make_segment=segment_builder(tokenizer, self._seek),
        )
        return [
            {"id": i, **seg, "partial": True}
            for i, seg in enumerate(segments, start=len(self._segments))
            if seg["start"] != seg["end"] and seg["text"].strip() != ""
        ]

    def flush(self) -> List[dict]:
        """Decode the remaining open window and end the stream."""
        if self._flushed:
            return []
        self._flushed = True
        return self._process(final=True)

    @property
    def decoded_seconds(self) -> float:
        """Stream position consumed by final decoding."""
        return self._seek * HOP_LENGTH / SAMPLE_RATE

    @property
    def result(self) -> dict:
        """transcribe()'s result over everything finished so far;
        `language` is None until detection pins it."""
        return {
            "text": "".join(seg["text"] for seg in self._segments),
            "segments": self._segments,
            "language": self.language,
        }
