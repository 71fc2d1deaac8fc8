"""Annotation CSV parsing and speaker indexing (the port's own copy of
seq2seq_abcd_vae_tpu/data/annotations.py, read with the ``csv`` module:
the port does not use pandas).

Same schema: columns ``input_path,onset,offset,data_type[,speaker]
[,label]``, onsets and offsets in seconds.  ``speaker2ix`` maps speaker
names (as strings) to ids in order of first appearance and is injectable,
so that a persisted ``speaker_coding.json`` survives resume.
"""

from __future__ import annotations

import csv
import os.path

import scipy.io.wavfile as spw

from .audio import SegmentDataset, WavCache


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
        self.input_root = input_root
        self.data_type_col_name = data_type_col_name
        self.wav_cache = WavCache(input_root)
        if "speaker" in self.columns:
            if speaker2ix is None:
                speaker2ix = {}
                for row in self.rows:
                    speaker2ix.setdefault(str(row["speaker"]),
                                          len(speaker2ix))
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

    def get_sample_freq(self, input_path: str | None = None) -> int:
        """fs of the first (or given) wav; all files are assumed to share
        it."""
        if input_path is None:
            input_path = self.rows[0]["input_path"]
        fs, _ = spw.read(os.path.join(self.input_root, input_path))
        return fs
