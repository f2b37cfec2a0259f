"""The port's writers, normalizers, registry and command line against the
JAX package's on the CPU: equal output files for every format and word
option, equal normalized text, equal registry tables, registry loading that
installs the published alignment heads (no network: the download is patched
to a local file and urlopen to raise), and `python -m whisper_tpu_torch
--device cpu` writing the files the JAX CLI writes from the same `.npz`."""

import json
import os
import random
import shutil
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu_torch
from whisper_tpu.normalizers import BasicTextNormalizer as JaxBasic
from whisper_tpu.normalizers import EnglishTextNormalizer as JaxEnglish
from whisper_tpu.normalizers.english import EnglishNumberNormalizer as JaxNumbers
from whisper_tpu_torch.models import registry
from whisper_tpu_torch.normalizers import BasicTextNormalizer, EnglishTextNormalizer
from whisper_tpu_torch.normalizers.english import EnglishNumberNormalizer, EnglishSpellingNormalizer
from whisper_tpu_torch.utils import get_writer

# the tier-1 run shares the cores among six test workers: one torch thread
# each keeps them from oversubscribing the machine
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = ["txt", "vtt", "srt", "tsv", "json"]

# ---- writers -----------------------------------------------------------------


def _result(with_words: bool) -> dict:
    """Three segments; words with a pause over 3 s, a leading space on each
    word, punctuation, a '-->' and a tab in the text."""
    rng = np.random.RandomState(4)
    texts = [
        " And so my fellow Americans, ask not what your country can do for you",
        " ask what you can do --> for\tyour country.",
        " Thank you.",
    ]
    segments, t = [], 0.36
    for i, text in enumerate(texts):
        words, start = [], t
        for w in text.split(" ")[1:]:
            dur = float(rng.uniform(0.1, 0.6))
            words.append(dict(word=" " + w, start=round(t, 2), end=round(t + dur, 2), probability=0.5))
            t += dur + (3.5 if i == 1 and w == "do" else 0.05)
        seg = dict(id=i, seek=0, start=round(start, 2), end=round(t, 2), text=text, tokens=[1, 2])
        if with_words:
            seg["words"] = words
        segments.append(seg)
        t += 0.2
    return dict(text="".join(texts), segments=segments, language="en")


WORD_OPTIONS = [
    {},
    dict(max_line_width=20),
    dict(max_line_width=24, max_line_count=2),
    dict(max_words_per_line=3),
    dict(highlight_words=True),
    dict(highlight_words=True, max_line_width=30, max_line_count=1),
]


@pytest.mark.parametrize("fmt", FORMATS + ["all"])
@pytest.mark.parametrize("options", range(len(WORD_OPTIONS)), ids=lambda i: f"opts{i}")
@pytest.mark.parametrize("with_words", [True, False], ids=["words", "segments"])
def test_writers_match_jax(fmt, options, with_words, tmp_path):
    from whisper_tpu.utils import get_writer as jax_get_writer

    result, kw = _result(with_words), WORD_OPTIONS[options]
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    get_writer(fmt, str(tmp_path / "port"))(result, "clip/jfk.flac", **kw)
    jax_get_writer(fmt, str(tmp_path / "jax"))(result, "clip/jfk.flac", **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(f"jfk.{f}" for f in (FORMATS if fmt == "all" else [fmt]))
    for name in names:
        mine = (tmp_path / "port" / name).read_bytes()
        assert mine == (tmp_path / "jax" / name).read_bytes(), name
        assert mine


# ---- normalizers -------------------------------------------------------------

# the inputs of tests/test_normalizer.py
NUMBER_INPUTS = [
    "two", "thirty one", "five twenty four", "nineteen ninety nine", "twenty nineteen",
    "two point five million", "four point two billions", "200 thousand",
    "200 thousand dollars", "$20 million", "€52.4 million", "£77 thousands",
    "two double o eight", "three thousand twenty nine", "forty three thousand two hundred sixty",
    "forty three thousand two hundred and sixty", "nineteen fifties", "thirty first",
    "thirty three thousand and three hundred and thirty third", "three billion", "millions",
    "july third twenty twenty", "august twenty sixth twenty twenty one", "3 14", "3.14",
    "3 point 2", "3 point 14", "fourteen point 4", "two point two five dollars",
    "two hundred million dollars", "$20.1 million", "ninety percent", "seventy six per cent",
    "double oh seven", "double zero seven", "nine one one", "nine double one",
    "one triple oh one", "two thousandth", "thirty two thousandth", "minus 500",
    "positive twenty thousand", "two dollars and seventy cents", "3 cents", "$0.36",
    "three euros and sixty five cents", "three and a half million",
    "forty eight and a half dollars", "b747", "10 th", "10th",
]  # fmt: skip
TEXT_INPUTS = [
    "Let's", "he's like", "she's been like", "10km", "10mm", "RC232",
    "Mr. Park visited Assoc. Prof. Kim Jr.", "Hello, World!", "[music] spoken (laughs) text",
    "Élève œuvre", "mobilisation", "cancelation",
]  # fmt: skip
FUZZ_VOCAB = (
    "one two three seven eleven nineteen twenty thirty ninety hundred "
    "thousand million billionth o oh zero double triple point and a half "
    "dollars cents euros pounds percent per cent minus plus first fifths "
    "twelfth hello world it's can't won't mr dr 3.14 1,000 2nd 1960s "
    "I'm we've they'll she'd o'clock $5 100% A.D. e.g. foo-bar "
    "colour honour mobilisation [noise] (aside) Élève œuvre ß"
).split()
UNICODE_WORDS = [
    "Héllo", "wörld", "한국어", "텍스트입니다", "नमस्ते", "दुनिया", "a\r\nb", "👩‍👩‍👧", "ÅÄÖ",
    "ไทย", "日本語の", "Ελληνικά", "café", "naïve", "Ǆemal", "ﬁne", "x̧́", "—", "¿Qué?",
]  # fmt: skip


def test_number_and_text_normalizers_match_jax():
    for mine, ref in ((EnglishNumberNormalizer(), JaxNumbers()), (EnglishTextNormalizer(), JaxEnglish())):
        for s in NUMBER_INPUTS + TEXT_INPUTS:
            assert mine(s) == ref(s), s
    assert EnglishNumberNormalizer()("two point two five dollars") == "$2.25"
    assert EnglishSpellingNormalizer()("mobilisation") == "mobilization"


def test_english_normalizer_fuzz_matches_jax():
    rng = random.Random(0)
    mine, ref = EnglishTextNormalizer(), JaxEnglish()
    for _ in range(300):
        s = " ".join(rng.choices(FUZZ_VOCAB, k=rng.randint(1, 12)))
        assert mine(s) == ref(s), s


@pytest.mark.parametrize("diacritics", [False, True], ids=["symbols", "diacritics"])
@pytest.mark.parametrize("split", [False, True], ids=["words", "letters"])
def test_basic_normalizer_matches_jax(diacritics, split):
    """Including split_letters, where the port splits grapheme clusters
    with `re` and unicodedata and the JAX package with `regex`."""
    rng = random.Random(1)
    mine, ref = BasicTextNormalizer(diacritics, split), JaxBasic(diacritics, split)
    cases = TEXT_INPUTS + UNICODE_WORDS
    cases += [" ".join(rng.choices(UNICODE_WORDS + FUZZ_VOCAB, k=rng.randint(1, 8))) for _ in range(200)]
    for s in cases:
        assert mine(s) == ref(s), repr(s)


# ---- registry ------------------------------------------------------------------


def test_registry_tables_match_jax(monkeypatch):
    from whisper_tpu.models import registry as jax_registry

    assert registry.available_models() == jax_registry.available_models()
    assert registry._CHECKPOINTS == jax_registry._CHECKPOINTS
    assert registry._MODELS == jax_registry._MODELS
    assert registry.ALIGNMENT_HEADS == jax_registry.ALIGNMENT_HEADS
    monkeypatch.setenv("XDG_CACHE_HOME", "/cache-home")
    assert registry.default_download_root() == jax_registry.default_download_root()
    assert set(registry.available_models()) == set(whisper_tpu_torch.MODEL_DIMS)


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise urllib.error.URLError("network access refused in this test")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def test_download_checkpoint_uses_a_verified_cache_and_fails_clearly(tmp_path, monkeypatch, no_network):
    name = "tiny"
    target = tmp_path / os.path.basename(registry._MODELS[name])
    target.write_bytes(b"checkpoint bytes")
    import hashlib

    monkeypatch.setitem(registry._CHECKPOINTS, name, hashlib.sha256(b"checkpoint bytes").hexdigest())
    assert registry.download_checkpoint(name, str(tmp_path)) == str(target)
    with pytest.raises(RuntimeError, match="could not be downloaded"):
        registry.download_checkpoint("base", str(tmp_path))
    with pytest.raises(RuntimeError, match="not found"):
        registry.download_checkpoint("no-such-model", str(tmp_path))


def test_load_model_by_name_installs_alignment_heads(tmp_path, monkeypatch, no_network):
    """A checkpoint with tiny's decoder shape (4 layers x 6 heads, narrow)
    stands in for the download; both packages install tiny's heads."""
    from oracle import save_reference_checkpoint
    from whisper_tpu.models.dims import ModelDimensions

    import whisper_tpu.models.registry as jax_registry

    dims = ModelDimensions(80, 1500, 48, 6, 1, 51865, 448, 48, 6, 4)
    path = save_reference_checkpoint(str(tmp_path / "tiny.pt"), dims, seed=3)
    monkeypatch.setattr(registry, "download_checkpoint", lambda name, root=None: path)
    monkeypatch.setattr(jax_registry, "download_checkpoint", lambda name, root=None: path)
    monkeypatch.setattr(whisper_tpu, "download_checkpoint", lambda name, root=None: path)
    monkeypatch.setattr(whisper_tpu_torch, "download_checkpoint", lambda name, root=None: path)

    mine = whisper_tpu_torch.load_model("tiny", device="cpu", compute_dtype=torch.float32)
    ref = whisper_tpu.load_model("tiny", compute_dtype="float32")
    assert mine.alignment_heads == ref.alignment_heads
    default = [(l, h) for l in range(2, 4) for h in range(6)]
    assert mine.alignment_heads != default and len(mine.alignment_heads) > 0
    # a local file keeps the default heads
    assert whisper_tpu_torch.load_model(path, device="cpu").alignment_heads == default


def test_cli_missing_registry_checkpoint_raises(tmp_path, monkeypatch, no_network, jfk_flac_path):
    from whisper_tpu_torch.cli import cli

    monkeypatch.setattr(
        sys, "argv",
        ["whisper-tpu-torch", jfk_flac_path, "--model", "tiny", "--model_dir", str(tmp_path),
         "--device", "cpu", "--output_dir", str(tmp_path / "out")],
    )  # fmt: skip
    with pytest.raises(RuntimeError, match="could not be downloaded"):
        cli()


def test_save_model_round_trips_and_matches_jax_layout(tmp_path, tpu_model, synth_checkpoint):
    mine = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)
    whisper_tpu_torch.save_model(mine, str(tmp_path / "port.npz"))
    whisper_tpu.save_model(tpu_model, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    again = whisper_tpu_torch.load_model(str(tmp_path / "port.npz"), device="cpu", compute_dtype=torch.float32)
    for (k, t), (_, u) in zip(mine.named_buffers(), again.named_buffers()):
        assert torch.equal(t, u), k


# ---- the command line ------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, synth_checkpoint):
    """Two copies of jfk.flac and the tiny model as a .npz."""
    d = tmp_path_factory.mktemp("cli")
    for name in ("a.flac", "b.flac"):
        shutil.copy(os.path.join(ROOT, "tests", "data", "jfk.flac"), d / name)
    model = whisper_tpu_torch.load_model(synth_checkpoint, device="cpu", compute_dtype=torch.float32)
    whisper_tpu_torch.save_model(model, str(d / "tiny.npz"))
    return d


def _same_json(a: dict, b: dict):
    assert a["text"] == b["text"] and a["language"] == b["language"]
    assert len(a["segments"]) == len(b["segments"]) > 0
    for m, r in zip(a["segments"], b["segments"]):
        assert m.keys() == r.keys()
        assert (m["id"], m["seek"], m["tokens"], m["text"]) == (r["id"], r["seek"], r["tokens"], r["text"])
        for k in ("start", "end", "temperature", "compression_ratio"):
            assert abs(m[k] - r[k]) < 1e-6, k
        for k in ("avg_logprob", "no_speech_prob"):
            assert abs(m[k] - r[k]) < 1e-4, k


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_cli_matches_jax_cli(cli_inputs, tmp_path, monkeypatch, parallel):
    """`python -m whisper_tpu_torch --device cpu` (a subprocess) and the
    JAX package's cli() on the same .npz and files: txt, vtt, srt and tsv
    byte for byte, json within 1e-6 s on times."""
    from whisper_tpu.cli import cli as jax_cli

    files = [str(cli_inputs / "a.flac"), str(cli_inputs / "b.flac")]
    common = [
        "--model", str(cli_inputs / "tiny.npz"), "--compute_dtype", "float32", "--language", "en",
        "--temperature", "0", "--temperature_increment_on_fallback", "None", "--verbose", "False",
        "--parallel", str(parallel),
    ]  # fmt: skip
    if not parallel:  # greedy here; the parallel run keeps the default beam 5
        common += ["--beam_size", "None", "--word_timestamps", "True", "--max_line_width", "30"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch", *files, *common, "--device", "cpu",
         "--output_dir", str(tmp_path / "port")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )  # fmt: skip
    assert out.returncode == 0, out.stderr
    monkeypatch.setenv("WHISPER_TPU_WEIGHTS", "")
    monkeypatch.setattr(sys, "argv", ["whisper-tpu", *files, *common, "--output_dir", str(tmp_path / "jax")])
    jax_cli()

    for stem in ("a", "b"):
        for fmt in ("txt", "vtt", "srt", "tsv"):
            mine = (tmp_path / "port" / f"{stem}.{fmt}").read_text(encoding="utf-8")
            assert mine == (tmp_path / "jax" / f"{stem}.{fmt}").read_text(encoding="utf-8"), (stem, fmt)
        mine = json.loads((tmp_path / "port" / f"{stem}.json").read_text(encoding="utf-8"))
        ref = json.loads((tmp_path / "jax" / f"{stem}.json").read_text(encoding="utf-8"))
        _same_json(mine, ref)
        if not parallel:
            words = [w for s in mine["segments"] for w in s["words"]]
            ref_words = [w for s in ref["segments"] for w in s["words"]]
            assert [w["word"] for w in words] == [w["word"] for w in ref_words] and words
            for x, y in zip(words, ref_words):
                assert abs(x["start"] - y["start"]) < 1e-6 and abs(x["end"] - y["end"]) < 1e-6


@pytest.mark.parametrize(
    "flag, message",
    [("--initial_prompt", "--parallel does not support --initial_prompt"),
     ("--clip_timestamps", "--parallel does not support --clip_timestamps")],
    ids=["initial_prompt", "clip_timestamps"],
)  # fmt: skip
def test_cli_parallel_refuses_unsupported_options(cli_inputs, tmp_path, monkeypatch, capsys, flag, message):
    """--parallel True with two files refuses --initial_prompt (which
    transcribe_batch does not take; the JAX CLI passes it on and fails with
    a TypeError) and --clip_timestamps: a parser error, exit code 2, and no
    file written."""
    from whisper_tpu_torch import cli

    value = "hello there" if flag == "--initial_prompt" else "1,5"
    files = [str(cli_inputs / "a.flac"), str(cli_inputs / "b.flac")]
    monkeypatch.setattr(
        sys, "argv",
        ["whisper-tpu-torch", *files, "--model", str(cli_inputs / "tiny.npz"), "--device", "cpu",
         "--compute_dtype", "float32", "--language", "en", "--parallel", "True", flag, value,
         "--output_dir", str(tmp_path / "out")],
    )  # fmt: skip
    with pytest.raises(SystemExit) as e:
        cli.cli()
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert os.listdir(tmp_path / "out") == []
