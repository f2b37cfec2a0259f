"""Transcript writers: txt / vtt / srt / tsv / json.

Copied from whisper_tpu/utils/writers.py (framework-free). The subtitle
writers wrap words into lines (`max_line_width`), break subtitles after
`max_line_count` lines, chunk by `max_words_per_line`, and underline each
word as it is spoken (`highlight_words`); without word timings they write
one cue per segment.
"""

import json
import os
import re
from typing import Callable, Iterator, List, Optional, TextIO, Tuple

from .helpers import format_timestamp


class ResultWriter:
    extension: str

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def __call__(
        self, result: dict, audio_path: str, options: Optional[dict] = None, **kwargs
    ):
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        output_path = os.path.join(self.output_dir, f"{stem}.{self.extension}")
        with open(output_path, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, options=options, **kwargs)

    def write_result(
        self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs
    ):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result, file, options=None, **kwargs):
        for segment in result["segments"]:
            print(segment["text"].strip(), file=file, flush=True)


def _iter_word_subtitles(
    segments: List[dict],
    max_line_width: Optional[int],
    max_line_count: Optional[int],
    max_words_per_line: Optional[int],
) -> Iterator[List[dict]]:
    """Group word timings into subtitle blocks, inserting '\n' line breaks.

    When both max_line_count and max_line_width are given, segment boundaries
    are ignored ("preserve_segments" off) and long pauses (>3 s) force breaks.
    """
    preserve_segments = max_line_count is None or max_line_width is None
    width_cap = max_line_width or 1000
    words_cap = max_words_per_line or 1000

    line_len = 0
    line_count = 1
    subtitle: List[dict] = []
    # start of the most recently consumed word, seeded from the first word
    last = next(
        (w["start"] for s in segments for w in s["words"]),
        segments[0]["start"] if segments else 0.0,
    ) or 0.0

    for segment in segments:
        words = segment["words"]
        chunk_start = 0
        while chunk_start < len(words):
            chunk = words[chunk_start : chunk_start + words_cap]
            for i, original in enumerate(chunk):
                timing = dict(original)
                long_pause = not preserve_segments and timing["start"] - last > 3.0
                has_room = line_len + len(timing["word"]) <= width_cap
                seg_break = i == 0 and subtitle and preserve_segments

                if line_len > 0 and has_room and not long_pause and not seg_break:
                    # continue the current line
                    line_len += len(timing["word"])
                else:
                    timing["word"] = timing["word"].strip()
                    needs_subtitle_break = (
                        subtitle
                        and max_line_count is not None
                        and (long_pause or line_count >= max_line_count)
                    ) or seg_break
                    if needs_subtitle_break:
                        yield subtitle
                        subtitle = []
                        line_count = 1
                    elif line_len > 0:
                        line_count += 1
                        timing["word"] = "\n" + timing["word"]
                    line_len = len(timing["word"].strip())
                subtitle.append(timing)
                last = timing["start"]
            chunk_start += words_cap

    if subtitle:
        yield subtitle


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def format_timestamp(self, seconds: float) -> str:
        return format_timestamp(
            seconds,
            always_include_hours=self.always_include_hours,
            decimal_marker=self.decimal_marker,
        )

    def iterate_result(
        self,
        result: dict,
        options: Optional[dict] = None,
        *,
        max_line_width: Optional[int] = None,
        max_line_count: Optional[int] = None,
        highlight_words: bool = False,
        max_words_per_line: Optional[int] = None,
    ) -> Iterator[Tuple[str, str, str]]:
        options = options or {}
        max_line_width = max_line_width or options.get("max_line_width")
        max_line_count = max_line_count or options.get("max_line_count")
        highlight_words = highlight_words or options.get("highlight_words", False)
        max_words_per_line = max_words_per_line or options.get("max_words_per_line")

        segments = result["segments"]
        have_words = len(segments) > 0 and "words" in segments[0]

        if not have_words:
            for segment in segments:
                yield (
                    self.format_timestamp(segment["start"]),
                    self.format_timestamp(segment["end"]),
                    segment["text"].strip().replace("-->", "->"),
                )
            return

        for subtitle in _iter_word_subtitles(
            segments, max_line_width, max_line_count, max_words_per_line
        ):
            sub_start = self.format_timestamp(subtitle[0]["start"])
            sub_end = self.format_timestamp(subtitle[-1]["end"])
            text = "".join(w["word"] for w in subtitle)
            if not highlight_words:
                yield sub_start, sub_end, text
                continue

            # karaoke mode: one cue per word, underlining the current word
            last = sub_start
            all_words = [w["word"] for w in subtitle]
            for i, w in enumerate(subtitle):
                start = self.format_timestamp(w["start"])
                end = self.format_timestamp(w["end"])
                if last != start:
                    yield last, start, text
                yield start, end, "".join(
                    re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", word) if j == i else word
                    for j, word in enumerate(all_words)
                )
                last = end


class WriteVTT(SubtitlesWriter):
    extension = "vtt"
    always_include_hours = False
    decimal_marker = "."

    def write_result(self, result, file, options=None, **kwargs):
        print("WEBVTT\n", file=file)
        for start, end, text in self.iterate_result(result, options, **kwargs):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(self, result, file, options=None, **kwargs):
        for i, (start, end, text) in enumerate(
            self.iterate_result(result, options, **kwargs), start=1
        ):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteTSV(ResultWriter):
    """start/end in integer milliseconds + text, tab-separated."""

    extension = "tsv"

    def write_result(self, result, file, options=None, **kwargs):
        print("start", "end", "text", sep="\t", file=file)
        for segment in result["segments"]:
            print(round(1000 * segment["start"]), file=file, end="\t")
            print(round(1000 * segment["end"]), file=file, end="\t")
            print(segment["text"].strip().replace("\t", " "), file=file, flush=True)


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result, file, options=None, **kwargs):
        json.dump(result, file)


_WRITERS = {
    "txt": WriteTXT,
    "vtt": WriteVTT,
    "srt": WriteSRT,
    "tsv": WriteTSV,
    "json": WriteJSON,
}


def get_writer(
    output_format: str, output_dir: str
) -> Callable[[dict, TextIO, dict], None]:
    if output_format == "all":
        all_writers = [cls(output_dir) for cls in _WRITERS.values()]

        def write_all(result, file, options=None, **kwargs):
            for writer in all_writers:
                writer(result, file, options, **kwargs)

        return write_all

    return _WRITERS[output_format](output_dir)
