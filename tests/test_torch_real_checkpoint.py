"""The port on official checkpoints: the real-weight end-to-end contract of
tests/test_real_checkpoint.py on tests/data/jfk.flac — the canonical "my
fellow Americans" transcript, text equal to its segments' concatenation,
the tokens' round trip through the tokenizer, the `<|0.00|>` start,
monotone word timings with "Americans" spanning 1.8 s; beam 5; language
detection.

There is no network here, so each test runs only when its official
checkpoint is already in the registry's cache (~/.cache/whisper or
$XDG_CACHE_HOME/whisper) and skips otherwise. The models run in float32 on
the card when there is one, else on the CPU.
`python -m whisper_tpu_torch.validate_real` runs this file with pytest
(without tests/conftest.py, which imports JAX), so it takes nothing from
conftest:

    python -m pytest tests/test_torch_real_checkpoint.py -v -m requires_weights
"""

import os

import pytest
import torch

JFK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jfk.flac")
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def _cached_checkpoint(name: str):
    """The cached official checkpoint's path, or None (nothing is downloaded)."""
    from whisper_tpu_torch.models.registry import _MODELS, default_download_root

    path = os.path.join(default_download_root(), os.path.basename(_MODELS[name]))
    return path if os.path.isfile(path) else None


def _load_real(name: str):
    if _cached_checkpoint(name) is None:
        pytest.skip(f"{name} checkpoint not cached (offline); see module docstring")
    import whisper_tpu_torch

    # float32: the reference's CPU float32 regime for near-ties
    return whisper_tpu_torch.load_model(name, device=DEVICE, compute_dtype=torch.float32)


@pytest.mark.requires_weights
@pytest.mark.parametrize("model_name", ["tiny", "tiny.en", "base", "turbo"])
def test_transcribe_real_checkpoint(model_name: str):
    from whisper_tpu_torch.tokenizer import get_tokenizer

    model = _load_real(model_name)
    language = "en" if model_name.endswith(".en") else None

    result = model.transcribe(JFK, language=language, temperature=0.0, word_timestamps=True)
    assert result["language"] == "en"
    assert result["text"] == "".join(s["text"] for s in result["segments"])

    transcription = result["text"].lower()
    assert "my fellow americans" in transcription
    assert "your country" in transcription
    assert "do for you" in transcription

    tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages)
    all_tokens = [t for s in result["segments"] for t in s["tokens"]]
    assert tokenizer.decode(all_tokens) == result["text"]
    assert tokenizer.decode_with_timestamps(all_tokens).startswith("<|0.00|>")

    timing_checked = False
    for segment in result["segments"]:
        for timing in segment["words"]:
            assert timing["start"] < timing["end"]
            if timing["word"].strip(" ,") == "Americans":
                assert timing["start"] <= 1.8
                assert timing["end"] >= 1.8
                timing_checked = True
    assert timing_checked


@pytest.mark.requires_weights
def test_beam_search_real_checkpoint():
    """Beam 5 on a real checkpoint gives the canonical text too."""
    model = _load_real("tiny.en")
    result = model.transcribe(JFK, language="en", temperature=0.0, beam_size=5)
    assert "my fellow americans" in result["text"].lower()


@pytest.mark.requires_weights
def test_language_detection_real_checkpoint():
    """Language detection on a real multilingual checkpoint says English."""
    from whisper_tpu_torch.audio import N_FRAMES, load_audio, log_mel_spectrogram, pad_or_trim

    model = _load_real("tiny")
    mel = log_mel_spectrogram(load_audio(JFK), model.dims.n_mels, padding=0)
    _, probs = model.detect_language(pad_or_trim(mel, N_FRAMES))  # the language token, its probabilities
    assert max(probs, key=probs.get) == "en"
    assert probs["en"] > 0.5
