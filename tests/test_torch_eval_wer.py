"""The port's WER harness (whisper_tpu_torch/eval_wer.py) against
tools/eval_wer.py and on the JAX harness's offline contract
(tests/test_eval_wer.py): the Levenshtein WER equal to the JAX tool's on
arbitrary word lists, the --ref/--hyp lines, and the LibriSpeech walker and
the --ref-dir form on a layout built from jfk.flac whose reference is the
synthetic model's own transcript (float32, T = 0 on the CPU), so the
overall WER is exactly 0."""

import os
import shutil
import sys

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import whisper_tpu_torch
from whisper_tpu_torch import eval_wer

TOOLS = os.path.join(os.path.dirname(__file__), os.pardir, "tools")
sys.path.insert(0, TOOLS)

from conftest import JFK  # noqa: E402
from eval_wer import word_error_rate as jax_word_error_rate  # noqa: E402

torch.set_num_threads(1)

WORDS = st.lists(st.sampled_from(["a", "b", "c", "the", "americans", "ask"]), max_size=12)


@settings(max_examples=200, deadline=None)
@given(WORDS, WORDS)
def test_word_error_rate_matches_the_tool(ref, hyp):
    assert eval_wer.word_error_rate(ref, hyp) == jax_word_error_rate(ref, hyp)


def test_word_error_rate_math():
    wer = eval_wer.word_error_rate
    assert wer("a b c".split(), "a x c".split()) == pytest.approx(1 / 3)
    assert wer("a b".split(), "a x b y".split()) == pytest.approx(1.0)
    assert wer([], []) == 0.0 and wer([], ["x"]) == 1.0
    assert wer(["a"], "x y z".split()) == 3.0  # above 1 when the hypothesis is longer


def test_ref_hyp_lines(tmp_path, capsys):
    """The per-utterance and overall lines, after the English normalizer
    (case, punctuation, spelled-out numbers)."""
    (tmp_path / "ref.txt").write_text("And so, my fellow Americans: ask not.")
    (tmp_path / "hyp.txt").write_text("and so my fellow americans ask")
    assert eval_wer.main(["--ref", str(tmp_path / "ref.txt"), "--hyp", str(tmp_path / "hyp.txt")]) == 0
    assert capsys.readouterr().out == "WER 0.1429  (7 ref words)\n\noverall WER: 0.1429 over 7 words\n"


def test_usage_error_without_inputs():
    with pytest.raises(SystemExit):
        eval_wer.main(["--ref", "only-one-side.txt"])


@pytest.fixture(scope="module")
def own_transcript(synth_checkpoint):
    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)
    text = model.transcribe(JFK, language="en", temperature=0.0, verbose=None)["text"].strip()
    assert text, "the synthetic model transcribed nothing"
    return text


def test_librispeech_layout_end_to_end(synth_checkpoint, own_transcript, tmp_path, capsys):
    """<root>/<spk>/<chap>/<spk>-<chap>-<utt>.flac beside
    <spk>-<chap>.trans.txt: two utterances (one without a reference line,
    which the walker leaves out), --limit, overall WER 0."""
    chap = tmp_path / "ls" / "1" / "2"
    chap.mkdir(parents=True)
    for utt in ("0000", "0001"):
        shutil.copy(JFK, chap / f"1-2-{utt}.flac")
    (chap / "1-2.trans.txt").write_text(f"1-2-0000 {own_transcript}\n")
    items = eval_wer.librispeech_items(str(tmp_path / "ls"))
    assert items == [(str(chap / "1-2-0000.flac"), own_transcript)]
    assert eval_wer.librispeech_items(str(tmp_path / "ls"), limit=1) == items
    rc = eval_wer.main(["--librispeech", str(tmp_path / "ls"), "--model", synth_checkpoint, "--device", "cpu",
                        "--dtype", "float32", "--temperature", "0", "--limit", "5"])  # fmt: skip
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("WER 0.0000") == 1 and "overall WER: 0.0000" in out, out


def test_ref_dir_form(synth_checkpoint, own_transcript, tmp_path, capsys):
    """refs/<name>.txt against <audio-dir>/<name>.flac; a reference without
    audio is skipped. The int8 weights mode decodes too (its WER printed,
    not held to 0), and the model's own mode is put back."""
    refs, audio = tmp_path / "refs", tmp_path / "audio"
    refs.mkdir()
    audio.mkdir()
    shutil.copy(JFK, audio / "jfk.flac")
    (refs / "jfk.txt").write_text(own_transcript)
    (refs / "missing.txt").write_text("no audio for this one")
    args = ["--ref-dir", str(refs), "--audio-dir", str(audio), "--model", synth_checkpoint, "--device", "cpu",
            "--dtype", "float32", "--temperature", "0"]  # fmt: skip
    assert eval_wer.main(args) == 0
    out, err = capsys.readouterr()
    assert "skipping missing: no matching audio" in err
    assert out.startswith("WER 0.0000") and "overall WER: 0.0000" in out, out

    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)
    assert eval_wer.main(args + ["--weights", "int8"], model=model) == 0
    assert "overall WER: " in capsys.readouterr().out
    assert model.decode_weights == "" and model._fused_engine.history[-1].steps > 0
