"""Continuous batching: a serving scheduler over the lockstep batched
decoder (the counterpart of whisper_tpu/continuous.py).

`transcribe_batch` needs every stream up front and holds the batch until
the longest stream finishes: right for offline jobs, wasteful for serving,
where requests arrive over time and a 10 s clip should not wait on a
10 min one. `ContinuousBatcher` keeps a number of SLOTS and admits queued
requests into the slots that free up at window granularity: each 30 s
round, finished streams leave and waiting ones enter, and a request
resolves in the round its stream completes. A stream's transcript does not
depend on which other streams shared its rounds: a round decodes and
applies its windows as transcribe_batch's does (batch._Rounds).

A round decodes the windows of its occupied slots only: the port's engine
runs eagerly, so a batch of another size costs no compile (the JAX package
keeps idle slots decoding silence so that its compiled shape stays fixed).

Usage::

    cb = ContinuousBatcher(model, slots=4, language="en")
    t1 = cb.submit(audio1)          # returns a ticket at once
    t2 = cb.submit(audio2)
    cb.drain()                      # or: while cb.step(): maybe_submit_more()
    result = cb.result(t1)          # transcribe()'s schema, plus "duration"
"""

import time
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np

from .audio import HOP_LENGTH, N_FRAMES, N_SAMPLES, SAMPLE_RATE, load_audio, log_mel_spectrogram
from .batch import _host_windows, _Rounds, _Stream, _stream_result
from .tokenizer import LANGUAGES, TO_LANGUAGE_CODE


def _language_code(language: str) -> str:
    """'English', 'EN' and 'en' -> 'en'; ValueError for an unknown one."""
    language = language.lower()
    language = TO_LANGUAGE_CODE.get(language, language)
    if language not in LANGUAGES:
        raise ValueError(f"unsupported language: {language!r}")
    return language


class _Request(_Stream):
    """One submitted stream: its host mel, or on a CUDA model its own mel
    on the card (ops/stft.device_mel_full, transcribe()'s mel)."""

    def __init__(self, ticket: int, mel, content_frames: int, device_mel=None):
        super().__init__(ticket, mel, content_frames)
        self.device_mel = device_mel


class ContinuousBatcher:
    """Window-granular continuous batching over `slots` slots.

    `submit` computes the request's mel (and detects its language when none
    is pinned); decoding happens in `step()` / `drain()`. With
    language=None each stream detects on submission and a round decodes one
    group per language. `condition_on_previous_text=True` (the default, as
    in transcribe()) gives each stream its own prompt after its first
    window; a round decodes one engine call per distinct prompt.

    `stats` holds monotonic counters for servers and metrics endpoints
    (pop() never resets them): requests submitted and completed, rounds and
    their wall seconds, windows decoded, and each round's wall seconds by
    phase. On a CUDA model the mel phase covers the host's slicing and
    stacking of the round's windows; those launches run asynchronously, so
    their device time lands in the decode phase, whose loops end in reads
    of the card. The apply phase is the host's segment bookkeeping and, with
    word timestamps, the alignment replay.
    """

    def __init__(
        self,
        model,
        slots: int = 4,
        *,
        language: Optional[str] = None,
        task: str = "transcribe",
        temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        word_timestamps: bool = False,
        prepend_punctuations: str = "\"'\u201c\u00bf([{-",
        append_punctuations: str = "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001",
        **decode_options,
    ):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        decode_options.pop("verbose", None)  # transcribe()'s signature; nothing is printed
        if language is not None:
            # the pin is normalized as requests are, so that they compare code to code
            language = _language_code(language)
        if language is None and not model.is_multilingual:
            language = "en"  # English-only models have no language tokens
        self.model = model
        self.slots = slots
        self.language = language
        self.task = task
        self._rounds = _Rounds(
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

        self._queue: deque = deque()  # tickets waiting for a slot
        self._slot_ticket: List[Optional[int]] = [None] * slots
        self._streams: Dict[int, _Request] = {}
        self._langs: Dict[int, str] = {}
        self._results: Dict[int, dict] = {}
        self._next_ticket = 0
        self.stats: Dict[str, float] = {
            "requests_submitted": 0,
            "requests_completed": 0,
            "rounds": 0,
            "round_seconds_sum": 0.0,
            "windows_decoded": 0,
            "mel_seconds_sum": 0.0,
            "decode_seconds_sum": 0.0,
            "apply_seconds_sum": 0.0,
        }

    # ---- API -------------------------------------------------------------------

    def submit(self, audio: Union[str, np.ndarray], *, language: Optional[str] = None) -> int:
        """Queue one audio (a path or a 16 kHz waveform) and return its
        ticket for `result()`. The mel is computed now; decoding happens in
        step() / drain(). `language` overrides detection for this request
        and must match the batcher's language where one is pinned. A
        request that raises leaves no state and counts nowhere."""
        if language is not None:
            language = _language_code(language)
            if self.language is not None and language != self.language:
                raise ValueError(f"batcher language is pinned to {self.language!r}")
        if isinstance(audio, str):
            try:
                audio = load_audio(audio)
            except ValueError:
                raise
            except Exception as e:
                # an undecodable upload is the caller's fault: servers answer
                # a ValueError with a 4xx
                raise ValueError(f"could not decode audio: {e}") from e
        audio = np.asarray(audio, np.float32)
        ticket = self._next_ticket
        if self.model.device.type == "cuda":
            from .ops.stft import device_mel_full, device_mel_window

            dmel, content_frames = device_mel_full(audio, self.model.dims.n_mels, self.model.device)
            s = _Request(ticket, None, content_frames, device_mel=dmel)
        else:
            mel = log_mel_spectrogram(audio, self.model.dims.n_mels, padding=N_SAMPLES)
            s = _Request(ticket, mel, mel.shape[-1] - N_FRAMES)
        if language is not None:
            lang = language
        elif self.language is not None:
            lang = self.language
        else:
            # the stream's full first window, frames of silence included, as
            # transcribe() detects on mel[:, :N_FRAMES]
            if s.device_mel is not None:
                first = device_mel_window(s.device_mel, 0, N_FRAMES)
            else:
                first = np.asarray(s.mel[:, :N_FRAMES], np.float32)
            _, probs = self.model.detect_language(first)
            lang = max(probs, key=probs.get)
        # commit: nothing below raises
        self._next_ticket += 1
        self._streams[ticket] = s
        self._langs[ticket] = lang
        self.stats["requests_submitted"] += 1
        if s.done:  # sub-second audio resolves at once, with empty text
            self._finalize(ticket)
        else:
            self._queue.append(ticket)
        return ticket

    def pending(self) -> int:
        """Requests not resolved yet (queued or in a slot)."""
        return len(self._streams) - len(self._results)

    def ready(self, ticket: int) -> bool:
        return ticket in self._results

    def result(self, ticket: int) -> dict:
        """The ticket's result in transcribe()'s schema; KeyError until it
        is finished."""
        if ticket not in self._results:
            raise KeyError(f"ticket {ticket} not finished (call step()/drain())")
        return self._results[ticket]

    def pop(self, ticket: int) -> dict:
        """result(), and the ticket's state evicted: a long-running server
        calls this, or each request's segments stay behind."""
        out = self.result(ticket)
        del self._results[ticket]
        del self._streams[ticket]
        del self._langs[ticket]
        return out

    def step(self) -> bool:
        """Admit queued requests into free slots and run one window round.
        Returns False when there is nothing left to do."""
        t0 = time.perf_counter()
        for i in range(self.slots):
            if self._slot_ticket[i] is None and self._queue:
                self._slot_ticket[i] = self._queue.popleft()
        occupied = [i for i, t in enumerate(self._slot_ticket) if t is not None]
        if not occupied:
            return False
        streams = [self._streams[self._slot_ticket[i]] for i in occupied]

        t_mel = time.perf_counter()
        sizes = [s.window_frames for s in streams]
        if self.model.device.type == "cuda":
            import torch

            from .ops.stft import device_mel_window

            mels = torch.stack(
                [device_mel_window(s.device_mel, s.seek, size) for s, size in zip(streams, sizes)]
            )
        else:
            mels = _host_windows(streams, sizes)
        t_dec = time.perf_counter()
        self.stats["mel_seconds_sum"] += t_dec - t_mel

        langs = [self._langs[s.idx] for s in streams]
        results = self._rounds.decode(streams, mels, langs)
        t_apply = time.perf_counter()
        self.stats["decode_seconds_sum"] += t_apply - t_dec

        for slot, s, lang, result in zip(occupied, streams, langs, results):
            self._rounds.apply(s, result, lang)
            if s.done:
                self._finalize(s.idx)
                self._slot_ticket[slot] = None
        t_end = time.perf_counter()
        self.stats["rounds"] += 1
        self.stats["round_seconds_sum"] += t_end - t0
        self.stats["apply_seconds_sum"] += t_end - t_apply
        self.stats["windows_decoded"] += len(streams)
        return True

    def drain(self) -> Dict[int, dict]:
        """step() until every submitted request has resolved; returns every
        ticket's result not popped yet."""
        while self.step():
            pass
        return dict(self._results)

    # ---- internals -------------------------------------------------------------

    def _finalize(self, ticket: int):
        s = self._streams[ticket]
        self.stats["requests_completed"] += 1
        out = _stream_result(self.model, s, self._langs[ticket], self.task)
        # the audio's true duration, which the servers report
        out["duration"] = round(s.content_frames * HOP_LENGTH / SAMPLE_RATE, 3)
        self._results[ticket] = out
        s.mel = None
        s.device_mel = None
