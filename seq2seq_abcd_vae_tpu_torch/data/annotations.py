"""Annotation CSV parsing and speaker indexing (the port's own copy of
seq2seq_abcd_vae_tpu/data/annotations.py, read with the ``csv`` module:
the port does not use pandas).

Same schema: columns ``input_path,onset,offset,data_type[,speaker]
[,label]``, onsets and offsets in seconds.  The JAX package reads the file
with ``pandas.read_csv``, which types each column, and keys speakers by
``astype(str)`` of the typed column; the port types the columns the same
way (:func:`type_column`), so both give the same speaker names and the
encode CSVs print the same annotation cells:

- pandas' missing-value strings (the empty cell, ``NA``, ``nan``, ...)
  are missing;
- a column whose other cells all look like integers is int, or float when
  it has a missing cell (``007`` -> ``7``, or ``7.0`` beside a blank);
- a column whose other cells all look like numbers is float;
- a column of ``True`` / ``False`` spellings is bool;
- anything else stays text.

``speaker2ix`` maps speaker names to ids in order of first appearance and
is injectable, so that a persisted ``speaker_coding.json`` (written by
either package) survives resume.
"""

from __future__ import annotations

import csv
import io
import math
import os.path
import re

import scipy.io.wavfile as spw

from .audio import SegmentDataset, WavCache

# pandas.read_csv's default missing-value strings
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?"
                    r"|[+-]?(inf|infinity)", re.IGNORECASE)
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})


def type_column(cells) -> tuple[str, list]:
    """Type a column of csv text as pandas.read_csv does.

    Returns (kind, values): kind is ``int``, ``float``, ``bool`` or
    ``str``; values are Python ints, floats (NaN where missing), bools or
    strings, None marking a missing cell of a bool or str column.
    """
    cells = ["" if c is None else c for c in cells]
    present = [c.strip() for c in cells if c not in NA_VALUES]
    missing = len(present) < len(cells)
    if all(_INT.fullmatch(c) for c in present) and not missing:
        return "int", [int(c) for c in cells]
    if all(_FLOAT.fullmatch(c) for c in present):
        return "float", [math.nan if c in NA_VALUES else float(c)
                         for c in cells]
    if all(c in _TRUE or c in _FALSE for c in present):
        return "bool", [None if c in NA_VALUES else c in _TRUE
                        for c in cells]
    return "str", [None if c in NA_VALUES else c for c in cells]


def as_str(value) -> str:
    """A typed cell as ``astype(str)`` renders it: the speaker key."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return "nan"
    return repr(value) if isinstance(value, float) else str(value)


def as_csv_cell(value) -> str:
    """A typed cell as ``DataFrame.to_csv`` prints it (missing: empty)."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return repr(value) if isinstance(value, float) else str(value)


class AnnotationParser:
    def __init__(self, input_root: str, annotation_file: str,
                 data_type_col_name: str = "data_type",
                 annotation_sep: str = ",",
                 speaker2ix: dict | None = None):
        with open(annotation_file, newline="") as f:
            reader = csv.DictReader(f, delimiter=annotation_sep)
            self.rows = list(reader)
            columns = reader.fieldnames or []
        missing = {"input_path", "onset", "offset"} - set(columns)
        if missing:
            raise ValueError(
                f"annotation file {annotation_file} is missing required "
                f"column(s) {sorted(missing)}; expected "
                "input_path,onset,offset,data_type[,speaker][,label] "
                f"(found {list(columns)}). Check --annotation_sep if the "
                "file is not comma-separated.")
        self.columns = list(columns)
        self.typed = {c: type_column([row[c] for row in self.rows])[1]
                      for c in self.columns}
        self.input_root = input_root
        self.data_type_col_name = data_type_col_name
        self.wav_cache = WavCache(input_root)
        if "speaker" in self.columns:
            # the JAX parser replaces the column by its astype(str)
            self.typed["speaker"] = [as_str(v)
                                     for v in self.typed["speaker"]]
            for row, key in zip(self.rows, self.typed["speaker"]):
                row["speaker"] = key
            if speaker2ix is None:
                speaker2ix = {}
                for key in self.typed["speaker"]:
                    speaker2ix.setdefault(key, len(speaker2ix))
            self.speaker2ix = speaker2ix
        else:
            self.speaker2ix = None

    def get_num_speakers(self) -> int:
        return 0 if self.speaker2ix is None else len(self.speaker2ix)

    def get_data(self, data_type: str | None = None,
                 channel: int = 0) -> SegmentDataset:
        """Rows of one data_type ('train' / 'valid'; None = all rows) as a
        SegmentDataset; each keeps its row number in the file as its
        index label."""
        picked = [(i, row) for i, row in enumerate(self.rows)
                  if data_type is None
                  or row[self.data_type_col_name] == data_type]
        return SegmentDataset(picked, self.wav_cache, channel=channel,
                              speaker2ix=self.speaker2ix)

    def csv_suffixes(self) -> dict[int, bytes]:
        """Row number -> ``,cell,cell,...`` of every annotation column, as
        the JAX encode writer's ``_annotation_suffixes`` gets them from
        pandas' ``to_csv`` (minimal quoting, missing cells empty)."""
        printed = [[as_csv_cell(v) for v in self.typed[c]]
                   for c in self.columns]
        buf = io.StringIO()
        writer = csv.writer(buf, lineterminator="\n")
        out = {}
        for i in range(len(self.rows)):
            buf.seek(0)
            buf.truncate()
            writer.writerow([i] + [col[i] for col in printed])
            out[i] = ("," + buf.getvalue()[:-1].split(",", 1)[1]).encode()
        return out

    def get_sample_freq(self, input_path: str | None = None) -> int:
        """fs of the first (or given) wav; all files are assumed to share
        it."""
        if input_path is None:
            input_path = self.rows[0]["input_path"]
        fs, _ = spw.read(os.path.join(self.input_root, input_path))
        return fs
