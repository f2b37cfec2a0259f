"""Per-window decoding: options, results, logit filters, greedy and beam
decoders, ranking, and the decoding task.

The counterpart of whisper_tpu/decoding.py, with the same option surface,
initial-token construction, suppression sets, timestamp rules and beam
bookkeeping. A window decodes on one of two loops:
  * the engine (engine.FusedEngine): the whole loop on the model's device,
    the filtered update in one kernel per token — the default;
  * the host loop (`DecodingTask._main_loop_host`), when the model's
    `use_fused_decode` is False: each step's logits come to the host as a
    float32 numpy copy, the filters' `apply` and the decoders' `update` run
    in numpy, and a beam reorder is carried to the next `decode_step` as a
    gather. It launches no update kernel.
"""

from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .audio import CHUNK_LENGTH
from .tokenizer import Tokenizer, get_tokenizer
from .utils import compression_ratio

if TYPE_CHECKING:
    from .models.whisper import Whisper


def _as_tensor(model: "Whisper", x) -> torch.Tensor:
    return torch.as_tensor(x).to(model.device)


def _host_f32(x: torch.Tensor) -> np.ndarray:
    """A writable float32 numpy copy of a device tensor."""
    return np.array(x.detach().to("cpu", torch.float32).numpy())


def _log_softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x.astype(np.float32)
    m = x.max(axis=axis, keepdims=True)
    s = x - m
    return s - np.log(np.exp(s).sum(axis=axis, keepdims=True))


@torch.inference_mode()
def detect_language(
    model: "Whisper", mel, tokenizer: Optional[Tokenizer] = None
) -> Tuple[np.ndarray, Union[dict, List[dict]]]:
    """Detect the spoken language from a mel window (or precomputed audio
    features). Returns (language token id(s), probability dict(s))."""
    if tokenizer is None:
        tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages)
    if tokenizer.language is None or tokenizer.language_token not in tokenizer.sot_sequence:
        raise ValueError("This model doesn't have language tokens so it can't perform lang id")

    mel = _as_tensor(model, mel)
    single = mel.ndim == 2
    if single:
        mel = mel[None]

    if tuple(mel.shape[-2:]) != (model.dims.n_audio_ctx, model.dims.n_audio_state):
        features = model.encode(mel)
    else:
        features = mel.to(model.compute_dtype)

    n_audio = features.shape[0]
    ck, cv = model.cross_kv(features)
    tokens = np.full((n_audio, 1), tokenizer.sot, dtype=np.int64)
    hidden, _ = model.prefill(tokens, 1, ck, cv)
    logits = model.hidden_to_logits(hidden[:, 0])  # (n_audio, vocab) f32

    keep = torch.zeros(logits.shape[-1], dtype=torch.bool, device=logits.device)
    keep[list(tokenizer.all_language_tokens)] = True
    logits = logits.masked_fill(~keep, float("-inf"))
    language_tokens = logits.argmax(dim=-1).cpu().numpy()
    probs = torch.softmax(logits, dim=-1).cpu().numpy()
    language_probs = [
        {
            c: float(probs[i, j])
            for j, c in zip(tokenizer.all_language_tokens, tokenizer.all_language_codes)
        }
        for i in range(n_audio)
    ]
    if single:
        return language_tokens[0], language_probs[0]
    return language_tokens, language_probs


@dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"  # "transcribe" or "translate"
    language: Optional[str] = None  # None -> auto-detect

    # sampling
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None  # independent samples when t > 0
    beam_size: Optional[int] = None  # beams when t == 0
    patience: Optional[float] = None  # beam search patience (arxiv:2204.05424)

    # ranking: None = length norm, else Google-NMT length penalty alpha
    length_penalty: Optional[float] = None

    prompt: Optional[Union[str, List[int]]] = None  # previous context
    prefix: Optional[Union[str, List[int]]] = None  # current-context prefix

    suppress_tokens: Optional[Union[str, Iterable[int]]] = "-1"
    suppress_blank: bool = True

    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0

    # kept for API compatibility; the compute dtype is the model's
    fp16: bool = True


@dataclass(frozen=True)
class DecodingResult:
    audio_features: object
    language: str
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


class Inference:
    """The decoder state of one decode() call: the cross-K/V (all the engine
    consumes), and for the host loop the 448-slot self-attention cache, its
    write offset and the beam reorder still to apply (carried into the next
    `decode_step` as a gather over the occupied slots)."""

    def __init__(self, model: "Whisper", n_group: int):
        self.model = model
        self.n_group = n_group
        self.ck = None
        self.cv = None
        self.text_offset = 0
        self.cache = None
        self.prefill_hidden = None
        self.pending_src: Optional[np.ndarray] = None

    def set_audio_features(self, audio_features, cross_kv=None):
        if cross_kv is not None:
            self.ck, self.cv = cross_kv
        else:
            self.ck, self.cv = self.model.cross_kv(audio_features)

    def logits(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (n_batch, cur_len) whole sequences. Returns the last
        position's logits (n_batch, n_vocab) as a writable float32 numpy
        copy. The first call runs the prefill, once per audio (a group's
        rows are equal then), and keeps its hidden states for logits_at()."""
        if self.text_offset == 0:
            unique = tokens[:: self.n_group]
            n = unique.shape[1]
            hidden, kv = self.model.prefill(unique, n, self.ck, self.cv)
            self.cache = self.model.kv_to_cache_grouped(kv, self.n_group)
            self.text_offset = n
            self.prefill_hidden = hidden
            last = _host_f32(self.model.hidden_to_logits(hidden[:, n - 1]))
            return np.repeat(last, self.n_group, axis=0)
        src = self.pending_src
        self.pending_src = None
        logits, self.cache = self.model.decode_step(
            tokens[:, -1].astype(np.int64), self.text_offset, self.cache, src, self.ck, self.cv
        )
        self.text_offset += 1
        return _host_f32(logits)

    def logits_at(self, position: int) -> np.ndarray:
        """The prefill's logits at an absolute position, per audio and
        repeated over its group (the no-speech probability at the sot)."""
        out = _host_f32(self.model.hidden_to_logits(self.prefill_hidden[:, position]))
        return np.repeat(out, self.n_group, axis=0)

    def rearrange_kv_cache(self, source_indices: Sequence[int]):
        src = np.asarray(source_indices, dtype=np.int64)
        if self.pending_src is None:
            self.pending_src = src
        else:  # compose with a reorder not applied yet
            self.pending_src = self.pending_src[src]

    def cleanup_caching(self):
        self.text_offset = 0
        self.cache = None
        self.prefill_hidden = None
        self.pending_src = None


class MaximumLikelihoodRanker:
    """Pick the sample with the highest logprob, normalized by simple length
    or the Google NMT length penalty."""

    def __init__(self, length_penalty: Optional[float]):
        self.length_penalty = length_penalty

    def rank(self, tokens, sum_logprobs):
        def scores(logprobs, lengths):
            result = []
            for logprob, length in zip(logprobs, lengths):
                if self.length_penalty is None:
                    result.append(logprob / length)
                else:
                    result.append(logprob / ((5 + length) / 6) ** self.length_penalty)
            return result

        lengths = [[len(t) for t in s] for s in tokens]
        return [np.argmax(scores(p, l)) for p, l in zip(sum_logprobs, lengths)]


class GreedyDecoder:
    def __init__(self, temperature: float, eot: int):
        self.temperature = temperature
        self.eot = eot

    def reset(self):
        pass

    def update(self, tokens, logits, sum_logprobs):
        """Host-loop step: argmax at T = 0, Gumbel-max at T > 0 from numpy's
        global stream (np.random.seed() makes it reproducible). Rows that
        ended stay at EOT."""
        if self.temperature == 0:
            next_tokens = logits.argmax(axis=-1)
        else:
            scaled = logits.astype(np.float64) / self.temperature
            gumbel = -np.log(-np.log(np.random.uniform(size=scaled.shape)))
            next_tokens = (scaled + gumbel).argmax(axis=-1)

        logprobs = _log_softmax(logits)
        current = logprobs[np.arange(logprobs.shape[0]), next_tokens]
        sum_logprobs += current * (tokens[:, -1] != self.eot)

        next_tokens[tokens[:, -1] == self.eot] = self.eot
        tokens = np.concatenate([tokens, next_tokens[:, None]], axis=-1)

        completed = bool((tokens[:, -1] == self.eot).all())
        return tokens, completed

    def finalize(self, tokens, sum_logprobs):
        tokens = np.pad(tokens, ((0, 0), (0, 0), (0, 1)), constant_values=self.eot)
        return tokens, sum_logprobs.tolist()


class BeamSearchDecoder:
    def __init__(
        self, beam_size: int, eot: int, inference: Inference, patience: Optional[float] = None
    ):
        self.beam_size, self.eot, self.inference = beam_size, eot, inference
        self.patience = patience or 1.0
        # finished candidates to collect per audio before stopping
        self.max_candidates: int = round(beam_size * self.patience)
        self.finished_sequences = None
        if self.max_candidates <= 0:
            raise ValueError(f"Invalid beam size ({beam_size}) or patience ({patience})")

    def reset(self):
        self.finished_sequences = None

    def update(self, tokens, logits, sum_logprobs):
        """Host-loop step: the top beam_size + 1 continuations of each beam,
        the best beam_size unfinished ones kept (their reorder handed to the
        Inference), EOT-ended ones poured into the per-audio pools."""
        if tokens.shape[0] % self.beam_size != 0:
            raise ValueError(f"{tokens.shape}[0] % {self.beam_size} != 0")

        n_audio = tokens.shape[0] // self.beam_size
        if self.finished_sequences is None:
            self.finished_sequences = [{} for _ in range(n_audio)]

        logprobs = _log_softmax(logits)
        next_tokens, source_indices, finished_sequences = [], [], []
        for i in range(n_audio):
            scores, sources, finished = {}, {}, {}

            # argpartition prunes the vocabulary, then a stable sort of the
            # small head keeps the exact tie order: ascending id on equal
            # values, as torch.topk and the kernels give it
            k = self.beam_size + 1
            for j in range(self.beam_size):
                idx = i * self.beam_size + j
                prefix = tokens[idx].tolist()
                row = logprobs[idx]
                head = np.argpartition(-row, k + 8)[: k + 8 + 1]
                head = head[np.lexsort((head, -row[head]))]
                for token in head[:k]:
                    sequence = tuple(prefix + [int(token)])
                    scores[sequence] = float(sum_logprobs[idx] + row[token])
                    sources[sequence] = idx

            saved = 0
            for sequence in sorted(scores, key=scores.get, reverse=True):
                if sequence[-1] == self.eot:
                    finished[sequence] = scores[sequence]
                    continue
                sum_logprobs[len(next_tokens)] = scores[sequence]
                next_tokens.append(sequence)
                source_indices.append(sources[sequence])
                saved += 1
                if saved == self.beam_size:
                    break
            finished_sequences.append(finished)

        tokens = np.array(next_tokens, dtype=tokens.dtype)
        self.inference.rearrange_kv_cache(source_indices)

        # this step's finishers join the pools, best first, up to
        # max_candidates; decoding completes once every pool is full
        for pool, fresh in zip(self.finished_sequences, finished_sequences):
            ranked = sorted(fresh, key=fresh.get, reverse=True)
            room = max(0, self.max_candidates - len(pool))
            pool.update((seq, fresh[seq]) for seq in ranked[:room])

        completed = all(len(pool) >= self.max_candidates for pool in self.finished_sequences)
        return tokens, completed

    def finalize(self, preceding_tokens, sum_logprobs):
        # fill with unfinished sequences if not enough finished ones exist
        sum_logprobs = np.asarray(sum_logprobs)
        for i, sequences in enumerate(self.finished_sequences):
            if len(sequences) < self.beam_size:
                for j in list(np.argsort(sum_logprobs[i]))[::-1]:
                    sequence = preceding_tokens[i, j].tolist() + [self.eot]
                    sequences[tuple(sequence)] = float(sum_logprobs[i][j])
                    if len(sequences) >= self.beam_size:
                        break

        tokens = [
            [np.array(seq) for seq in sequences.keys()]
            for sequences in self.finished_sequences
        ]
        sum_logprobs = [list(sequences.values()) for sequences in self.finished_sequences]
        return tokens, sum_logprobs


class LogitFilter:
    """A filter's attributes are the engine's suppression arguments (the
    engine applies them on the device); `apply` is the host loop's, on a
    numpy (n_batch, n_vocab) logits array, in place."""

    def apply(self, logits: np.ndarray, tokens: np.ndarray) -> None:
        raise NotImplementedError


class SuppressBlank(LogitFilter):
    def __init__(self, tokenizer: Tokenizer, sample_begin: int):
        self.suppress = tokenizer.encode(" ") + [tokenizer.eot]
        self.sample_begin = sample_begin

    def apply(self, logits, tokens):
        if tokens.shape[1] == self.sample_begin:
            logits[:, self.suppress] = -np.inf


class SuppressTokens(LogitFilter):
    def __init__(self, suppress_tokens: Sequence[int]):
        self.suppress_tokens = list(suppress_tokens)

    def apply(self, logits, tokens):
        logits[:, self.suppress_tokens] = -np.inf


class ApplyTimestampRules(LogitFilter):
    def __init__(
        self,
        tokenizer: Tokenizer,
        sample_begin: int,
        max_initial_timestamp_index: Optional[int],
    ):
        self.tokenizer = tokenizer
        self.sample_begin = sample_begin
        self.max_initial_timestamp_index = max_initial_timestamp_index

    def apply(self, logits, tokens):
        """Timestamps come in pairs (but before EOT), never decrease, open
        the sample, respect max_initial_timestamp, and win over text when
        their total probability beats every text token's."""
        tok = self.tokenizer
        if tok.no_timestamps is not None:
            logits[:, tok.no_timestamps] = -np.inf

        for k in range(tokens.shape[0]):
            seq = tokens[k, self.sample_begin :].tolist()
            last_was_timestamp = len(seq) >= 1 and seq[-1] >= tok.timestamp_begin
            penultimate_was_timestamp = len(seq) < 2 or seq[-2] >= tok.timestamp_begin

            if last_was_timestamp:
                if penultimate_was_timestamp:  # a closed pair: text next
                    logits[k, tok.timestamp_begin :] = -np.inf
                else:  # mid-pair: no text
                    logits[k, : tok.eot] = -np.inf

            timestamps = [t for t in seq if t >= tok.timestamp_begin]
            if timestamps:
                # monotonic timestamps, and segments of nonzero length
                if last_was_timestamp and not penultimate_was_timestamp:
                    timestamp_last = timestamps[-1]
                else:
                    timestamp_last = timestamps[-1] + 1
                logits[k, tok.timestamp_begin : timestamp_last] = -np.inf

        if tokens.shape[1] == self.sample_begin:
            logits[:, : tok.timestamp_begin] = -np.inf
            if self.max_initial_timestamp_index is not None:
                last_allowed = tok.timestamp_begin + self.max_initial_timestamp_index
                logits[:, last_allowed + 1 :] = -np.inf

        logprobs = _log_softmax(logits)
        for k in range(tokens.shape[0]):
            ts_slice = logprobs[k, tok.timestamp_begin :]
            m = ts_slice.max()
            timestamp_logprob = (
                m + np.log(np.exp(ts_slice - m).sum()) if np.isfinite(m) else -np.inf
            )
            max_text_token_logprob = logprobs[k, : tok.timestamp_begin].max()
            if timestamp_logprob > max_text_token_logprob:
                logits[k, : tok.timestamp_begin] = -np.inf


class DecodingTask:
    """One decode attempt: tokenizer, initial tokens, token decoder, logit
    filters, and the engine or the host loop (whisper_tpu/decoding.py's
    DecodingTask)."""

    def __init__(self, model: "Whisper", options: DecodingOptions):
        self.model = model
        self.options: DecodingOptions = self._verify_options(options)
        tokenizer = get_tokenizer(
            model.is_multilingual,
            num_languages=model.num_languages,
            language=options.language or "en",
            task=options.task,
        )
        self.tokenizer: Tokenizer = tokenizer

        self.n_group: int = options.beam_size or options.best_of or 1
        self.n_ctx: int = model.dims.n_text_ctx
        self.sample_len: int = options.sample_len or model.dims.n_text_ctx // 2

        self.sot_sequence = (
            tokenizer.sot_sequence_including_notimestamps
            if self.options.without_timestamps
            else tokenizer.sot_sequence
        )
        self.initial_tokens: Tuple[int, ...] = self._get_initial_tokens()
        self.sample_begin: int = len(self.initial_tokens)
        self.sot_index: int = self.initial_tokens.index(tokenizer.sot)

        self.inference = Inference(model, self.n_group)
        self._draft_ckv = None  # the draft's cross-K/V when this run speculates
        self.sequence_ranker = MaximumLikelihoodRanker(options.length_penalty)

        if options.beam_size is not None:
            self.decoder = BeamSearchDecoder(
                options.beam_size, tokenizer.eot, self.inference, options.patience
            )
        else:
            self.decoder = GreedyDecoder(options.temperature, tokenizer.eot)

        self.logit_filters: List[LogitFilter] = []
        if self.options.suppress_blank:
            self.logit_filters.append(SuppressBlank(self.tokenizer, self.sample_begin))
        if self.options.suppress_tokens:
            self.logit_filters.append(SuppressTokens(self._get_suppress_tokens()))
        if not options.without_timestamps:
            precision = CHUNK_LENGTH / model.dims.n_audio_ctx  # usually 0.02 s
            max_initial_timestamp_index = None
            if options.max_initial_timestamp:
                max_initial_timestamp_index = round(options.max_initial_timestamp / precision)
            self.logit_filters.append(
                ApplyTimestampRules(tokenizer, self.sample_begin, max_initial_timestamp_index)
            )

    def _verify_options(self, options: DecodingOptions) -> DecodingOptions:
        bad = None
        if options.beam_size is not None and options.best_of is not None:
            bad = "beam_size and best_of can't be given together"
        elif options.temperature == 0 and options.best_of is not None:
            bad = "best_of with greedy sampling (T=0) is not compatible"
        elif options.patience is not None and options.beam_size is None:
            bad = "patience requires beam_size to be given"
        elif options.length_penalty is not None and not (0 <= options.length_penalty <= 1):
            bad = "length_penalty (alpha) should be a value between 0 and 1"
        if bad:
            raise ValueError(bad)
        return options

    def _get_initial_tokens(self) -> Tuple[int, ...]:
        """[sot_prev + trimmed prompt] + sot_sequence + [trimmed prefix]."""

        def as_ids(text_or_ids) -> List[int]:
            if isinstance(text_or_ids, str):
                return self.tokenizer.encode(" " + text_or_ids.strip())
            return list(text_or_ids)

        seq = list(self.sot_sequence)
        if self.options.prefix:
            prefix = as_ids(self.options.prefix)
            if self.sample_len is not None:
                prefix = prefix[-(self.n_ctx // 2 - self.sample_len) :]
            seq += prefix
        if self.options.prompt:
            prompt = as_ids(self.options.prompt)
            seq = [self.tokenizer.sot_prev] + prompt[-(self.n_ctx // 2 - 1) :] + seq
        return tuple(seq)

    def _get_suppress_tokens(self) -> Tuple[int, ...]:
        suppress_tokens = self.options.suppress_tokens

        if isinstance(suppress_tokens, str):
            suppress_tokens = [int(t) for t in suppress_tokens.split(",")]

        if -1 in suppress_tokens:
            suppress_tokens = [t for t in suppress_tokens if t >= 0]
            suppress_tokens.extend(self.tokenizer.non_speech_tokens)
        elif suppress_tokens is None or len(suppress_tokens) == 0:
            suppress_tokens = []
        elif not isinstance(suppress_tokens, list):
            raise TypeError("suppress_tokens must be a list")

        tok = self.tokenizer
        suppress_tokens = list(suppress_tokens)
        suppress_tokens += [tok.transcribe, tok.translate, tok.sot, tok.sot_prev, tok.sot_lm]
        if tok.no_speech is not None:
            suppress_tokens.append(tok.no_speech)
        return tuple(sorted(set(suppress_tokens)))

    def _detect_language(self, audio_features, tokens: np.ndarray):
        languages = [self.options.language] * audio_features.shape[0]
        lang_probs = None

        if self.options.language is None or self.options.task == "lang_id":
            lang_tokens, lang_probs = detect_language(self.model, audio_features, self.tokenizer)
            languages = [max(probs, key=probs.get) for probs in lang_probs]
            if self.options.language is None:
                tokens[:, self.sot_index + 1] = lang_tokens

        return languages, lang_probs

    def _can_fuse(self) -> bool:
        """The engine decodes unless the model's `use_fused_decode` is off.
        Initial tokens past the 256-token prefill window raise on either
        loop."""
        return getattr(self.model, "use_fused_decode", True)

    def _main_loop(self, tokens: np.ndarray):
        if self._can_fuse():
            return self._main_loop_fused(tokens)
        return self._main_loop_host(tokens)

    def _main_loop_host(self, tokens: np.ndarray):
        """The host loop: per token, the step's logits as a float32 numpy
        copy, the filters, then the decoder's update."""
        n_batch = tokens.shape[0]
        sum_logprobs = np.zeros(n_batch, dtype=np.float64)
        no_speech_probs = [np.nan] * n_batch

        try:
            for i in range(self.sample_len):
                logits = self.inference.logits(tokens)

                if i == 0 and self.tokenizer.no_speech is not None:
                    probs_at_sot = np.exp(_log_softmax(self.inference.logits_at(self.sot_index)))
                    no_speech_probs = probs_at_sot[:, self.tokenizer.no_speech].tolist()

                for logit_filter in self.logit_filters:
                    logit_filter.apply(logits, tokens)

                tokens, completed = self.decoder.update(tokens, logits, sum_logprobs)

                if completed or tokens.shape[-1] > self.n_ctx:
                    break
        finally:
            self.inference.cleanup_caching()

        return tokens, sum_logprobs, no_speech_probs

    def _can_speculate(self) -> bool:
        """The speculative engine takes the greedy temperature-0 attempts of
        a model with a draft (set_draft_model), when the verify pass's K + 1
        slots fit after the longest decode; beam search and the t > 0
        ladder run the plain engine."""
        if getattr(self.model, "draft_model", None) is None:
            return False
        k = self.model.draft_k
        return (
            self.options.beam_size is None
            and self.options.temperature == 0
            and self.n_group == 1
            and self.sample_begin + self.sample_len <= self.n_ctx - k - 1
        )

    def _engines(self):
        """The model's cached engine for its weights mode, and its cached
        speculative engine for its draft when this run speculates; with a
        mesh (model.set_mesh) both are the sharded engines of
        parallel/serve.py."""
        from .engine import model_engine
        from .speculative import SpeculativeEngine

        model = self.model
        engine = model_engine(model, getattr(model, "decode_weights", ""))
        weights = engine.weights
        if self._draft_ckv is None:
            return engine, None
        mesh = model.mesh
        key = (id(model.draft_model), model.draft_k, weights, id(mesh) if mesh is not None else None)
        if model._spec_engine is None or model._spec_engine_key != key:
            if mesh is None:
                model._spec_engine = SpeculativeEngine(
                    model, model.draft_model, k=model.draft_k, weights=weights
                )
            else:
                from .parallel.serve import DataParallelSpeculativeEngine

                model._spec_engine = DataParallelSpeculativeEngine(
                    model, model.draft_model, mesh, k=model.draft_k, weights=weights
                )
            model._spec_engine_key = key
        return engine, model._spec_engine

    def _main_loop_fused(self, tokens: np.ndarray):
        """Run the sampling loop in the engine (or, with a draft, the
        speculative engine) and convert its outputs; beam pools are poured
        into BeamSearchDecoder.finished_sequences so that finalize() and
        ranking behave as on the host loop."""
        engine, spec = self._engines()

        tokenizer = self.tokenizer
        beam_search = self.options.beam_size is not None
        suppress_ids, blank_ids, max_initial = [], [], None
        use_timestamps = False
        for f in self.logit_filters:
            if isinstance(f, SuppressTokens):
                suppress_ids = f.suppress_tokens
            elif isinstance(f, SuppressBlank):
                blank_ids = f.suppress
            elif isinstance(f, ApplyTimestampRules):
                use_timestamps = True
                max_initial = f.max_initial_timestamp_index

        rows = tokens[:: self.n_group].astype(np.int32)
        common = dict(
            sot_index=self.sot_index,
            suppress_ids=suppress_ids,
            blank_ids=blank_ids,
            max_initial_ts_index=max_initial if use_timestamps else None,
            sample_len=self.sample_len,
            n_group=self.n_group,
            beam_search=beam_search,
            max_candidates=self.decoder.max_candidates if beam_search else 0,
            use_timestamps=use_timestamps,
            temperature=self.options.temperature,
            eot=tokenizer.eot,
            timestamp_begin=tokenizer.timestamp_begin,
            no_timestamps=tokenizer.no_timestamps,
            no_speech=tokenizer.no_speech if tokenizer.no_speech is not None else 0,
        )
        if spec is not None:
            # the draft proposes, the target verifies: the tokens are the
            # target's filtered argmax, as on the plain engine
            out = spec.run(
                rows, self.inference.ck, self.inference.cv, *self._draft_ckv, **common
            )
        else:
            out = engine.run(
                rows, self.inference.ck, self.inference.cv, **common,
                rng_seed=(
                    np.random.randint(0, 2**31 - 1) if self.options.temperature > 0 else 0
                ),
            )  # fmt: skip
        out_tokens, n_tokens, sum_logprobs, no_speech_prob, ftok, fscore, flen, fcount = out

        n = int(n_tokens)
        tokens = out_tokens[:, :n].astype(np.int64)
        sum_logprobs = sum_logprobs.astype(np.float64)
        if tokenizer.no_speech is not None:
            no_speech_probs = [float(p) for p in no_speech_prob for _ in range(self.n_group)]
        else:
            no_speech_probs = [np.nan] * tokens.shape[0]

        if beam_search:
            pools = []
            for a in range(ftok.shape[0]):
                finished = {}
                for i in range(int(fcount[a])):
                    seq = tuple(int(t) for t in ftok[a, i, : int(flen[a, i])])
                    finished[seq] = float(fscore[a, i])
                pools.append(finished)
            self.decoder.finished_sequences = pools

        return tokens, sum_logprobs, no_speech_probs

    def run(self, mel) -> List[DecodingResult]:
        self.decoder.reset()
        tokenizer = self.tokenizer
        mel = _as_tensor(self.model, mel)
        n_audio = mel.shape[0]

        if tuple(mel.shape[-2:]) == (self.model.dims.n_audio_ctx, self.model.dims.n_audio_state):
            audio_features, cross_kv = mel.to(self.model.compute_dtype), None
        else:
            audio_features, ck, cv = self.model.encode_with_cross_kv(mel)
            cross_kv = (ck, cv)
        tokens = np.tile(np.array([self.initial_tokens], dtype=np.int64), (n_audio, 1))

        languages, language_probs = self._detect_language(audio_features, tokens)
        if self.options.task == "lang_id":
            return [
                DecodingResult(audio_features=features, language=language, language_probs=probs)
                for features, language, probs in zip(audio_features, languages, language_probs)
            ]

        self.inference.set_audio_features(audio_features, cross_kv)
        # with a draft, its cross-K/V from the same mel: one more encode
        self._draft_ckv = None
        if cross_kv is not None and self._can_fuse() and self._can_speculate():
            _, dck, dcv = self.model.draft_model.encode_with_cross_kv(mel)
            self._draft_ckv = (dck, dcv)
        tokens = np.repeat(tokens, self.n_group, axis=0)
        tokens, sum_logprobs, no_speech_probs = self._main_loop(tokens)

        no_speech_probs = no_speech_probs[:: self.n_group]
        tokens = tokens.reshape(n_audio, self.n_group, -1)
        sum_logprobs = sum_logprobs.reshape(n_audio, self.n_group)

        tokens, sum_logprobs = self.decoder.finalize(tokens, sum_logprobs)
        tokens = [
            [t[self.sample_begin : np.nonzero(t == tokenizer.eot)[0][0]] for t in s]
            for s in tokens
        ]

        selected = self.sequence_ranker.rank(tokens, sum_logprobs)
        tokens: List[List[int]] = [[int(v) for v in t[i]] for i, t in zip(selected, tokens)]
        texts: List[str] = [tokenizer.decode(t).strip() for t in tokens]

        sum_logprobs: List[float] = [lp[i] for i, lp in zip(selected, sum_logprobs)]
        avg_logprobs: List[float] = [lp / (len(t) + 1) for t, lp in zip(tokens, sum_logprobs)]

        fields = (texts, languages, tokens, list(audio_features), avg_logprobs, no_speech_probs)
        if len(set(map(len, fields))) != 1:
            raise RuntimeError(f"inconsistent result lengths: {list(map(len, fields))}")

        return [
            DecodingResult(
                audio_features=features,
                language=language,
                tokens=tokens,
                text=text,
                temperature=self.options.temperature,
                avg_logprob=avg_logprob,
                compression_ratio=compression_ratio(text),
                no_speech_prob=no_speech_prob,
            )
            for text, language, tokens, features, avg_logprob, no_speech_prob in zip(*fields)
        ]


def decode(
    model: "Whisper",
    mel,
    options: Optional[DecodingOptions] = None,
    **kwargs,
) -> Union[DecodingResult, List[DecodingResult]]:
    """Decode 30-second mel window(s): mel (n_mels, 3000) or (B, n_mels, 3000)."""
    mel = _as_tensor(model, mel)
    if single := mel.ndim == 2:
        mel = mel[None]

    options = options or DecodingOptions()
    if kwargs:
        options = replace(options, **kwargs)

    result = DecodingTask(model, options).run(mel)
    return result[0] if single else result
