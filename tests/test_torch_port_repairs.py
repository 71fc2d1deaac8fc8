"""Faults of the PyTorch port against the JAX package, each repaired and
held here: the annotation's column typing and speaker keys (as pandas
types them for the JAX parser), the tolerant encoder load and round-1
pickle checkpoints (as the JAX ``retrieve_model`` / ``load_checkpoint``
read them), the bucket-policy environment overrides and the JAX package's
three bf16 precision switches, which the port refuses instead of
ignoring, and ``--matmul_precision``, which means the same in the
training, encode and serve CLIs.  pandas is used here as the reference
only; the port does not import it."""

import io
import json
import logging
import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from seq2seq_abcd_vae_tpu.data.annotations import (
    AnnotationParser as JaxParser)
from seq2seq_abcd_vae_tpu.infer.encode import _annotation_suffixes
from seq2seq_abcd_vae_tpu.train import checkpoint as jax_ckpt
from seq2seq_abcd_vae_tpu_torch.data.annotations import AnnotationParser
from seq2seq_abcd_vae_tpu_torch.data.batching import DataLoader, FrontendSpec
from seq2seq_abcd_vae_tpu_torch.infer.encode import Encoder
from seq2seq_abcd_vae_tpu_torch.train import checkpoint as port_ckpt
from seq2seq_abcd_vae_tpu_torch.train.from_jax import params_from_jax
from seq2seq_abcd_vae_tpu_torch.configs import EncoderConfig
from seq2seq_abcd_vae_tpu_torch.cli import (encode_main, learning_main,
                                            serve_main)
from torch_port_fixtures import (few_torch_threads_fixture, small_model,
                                 write_jax_checkpoint)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "fixtures", "toy_data")
WAV = "20170806-080002_89.2-94.22.1ch.wav"


def _write(tmp_path, name, header, rows) -> str:
    path = tmp_path / name
    path.write_text(header + "\n" + "\n".join(rows) + "\n")
    return str(path)


def _pandas_speaker_keys(path) -> list:
    """What the JAX parser keys speakers by: ``astype(str)`` of the column
    pandas typed (NaN renders as 'nan', as pandas 2's astype(str) gives
    it; pandas 3 keeps it missing)."""
    col = pd.read_csv(path)["speaker"]
    return [s if isinstance(s, str) else "nan" for s in col.astype(str)]


@pytest.mark.parametrize("speakers", [["007", "12", "3"],
                                      ["007", "", "12"],
                                      ["007", "x", "12"],
                                      ["1.5", "2", "NA"]])
def test_speaker_keys_follow_pandas_typing(tmp_path, speakers):
    """``007`` is the integer 7; beside a blank the column is float, so
    ``12`` is ``12.0`` and the blank ``nan``; a non-numeric cell keeps the
    column text."""
    rows = [f"{WAV},{0.1 * i:.1f},{0.1 * i + 0.05:.2f},train,{s}"
            for i, s in enumerate(speakers)]
    path = _write(tmp_path, "a.csv",
                  "input_path,onset,offset,data_type,speaker", rows)
    parser = AnnotationParser(TOY, path)
    want = _pandas_speaker_keys(path)
    assert [r["speaker"] for r in parser.rows] == want
    assert list(parser.speaker2ix) == list(dict.fromkeys(want))
    if speakers == ["007", "", "12"]:
        assert list(parser.speaker2ix) == ["7.0", "nan", "12.0"]


def test_annotation_cells_print_as_pandas(tmp_path):
    """The encode CSV's annotation columns: each column typed as pandas
    types it and printed as ``to_csv`` prints it, byte for byte against
    the JAX writer's ``_annotation_suffixes``."""
    cols = {"onset": ["0.383629", "1.", "2"],
            "offset": ["0.81", "1.5e0", "2.25"],
            "input_path": [WAV] * 3, "data_type": ["train", "valid", "NA"],
            "speaker": ["007", "", "12"], "label": ["A", 'b"c', "x,y"],
            "n": ["007", "+5", "-0"], "flag": ["True", "false", "TRUE"],
            "maybe": ["True", "", "False"], "big": ["1e16", "1e-05", "inf"],
            "gap": ["", "", ""], "text": ["1_000", " 7", "a"]}
    quote = lambda v: f'"{v.replace(chr(34), 2 * chr(34))}"' if (
        "," in v or '"' in v) else v
    path = _write(tmp_path, "b.csv", ",".join(cols),
                  [",".join(quote(v) for v in row)
                   for row in zip(*cols.values())])
    parser = AnnotationParser(TOY, path)
    df = pd.read_csv(path)
    df["speaker"] = _pandas_speaker_keys(path)  # the JAX parser's column
    want = _annotation_suffixes(df)
    assert parser.csv_suffixes() == want
    assert parser.columns == list(df.columns)


def test_speaker_coding_resumes_across_packages(tmp_path):
    """A speaker_coding.json written from either package's parser (the
    CLIs json.dump its speaker2ix) resumes in the other: same ids for
    every segment."""
    speakers = ["007", "x", "12", "x", "007"]
    rows = [f"{0.1 * i:.1f},{0.1 * i + 0.05:.2f},{WAV},train,{s},L"
            for i, s in enumerate(speakers)]
    path = _write(tmp_path, "c.csv",
                  "onset,offset,input_path,data_type,speaker,label", rows)
    jax_parser, port_parser = JaxParser(TOY, path), AnnotationParser(TOY,
                                                                     path)
    assert port_parser.speaker2ix == jax_parser.speaker2ix
    for writer in (jax_parser, port_parser):
        coding = json.loads(json.dumps(writer.speaker2ix))
        jax_ids = JaxParser(TOY, path, speaker2ix=coding).get_data(
            "train").speakers_np
        port_ids = AnnotationParser(TOY, path, speaker2ix=coding).get_data(
            "train").speakers_np
        np.testing.assert_array_equal(port_ids, jax_ids)
        np.testing.assert_array_equal(port_ids, [0, 1, 2, 1, 0])


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _capture(name):
    log, handler = logging.getLogger(name), _Messages()
    log.addHandler(handler)
    return log, handler


def test_encoder_loads_tolerantly_as_jax(tmp_path):
    """A key the checkpoint's encoder lacks keeps its fresh init, one it
    has beyond the config's is dropped, each with the JAX package's
    warning; the rest of the weights load as they are."""
    cfg, params = small_model(hidden=4, k=3, feature_dim=5)
    pcfg = EncoderConfig(cfg.encoder.input_size, 4)
    log, handler = _capture("seq2seq_abcd_vae_tpu_torch")
    try:
        extra = dict(params, encoder=dict(params["encoder"],
                                          stale=np.ones(2, np.float32)))
        got = params_from_jax(extra, pcfg)
        lacking = dict(params, encoder={})
        fresh = params_from_jax(lacking, pcfg)
    finally:
        log.removeHandler(handler)
    np.testing.assert_array_equal(
        got["encoder"][0]["w_hh"][1].numpy(),
        params["encoder"]["layers"][0]["bwd"]["w_hh"])
    assert fresh["encoder"][0]["w_hh"].shape == (2, 4, 16)
    # the same warnings as the JAX overlay with strict=False
    jlog, jhandler = _capture("repairs-jax-overlay")
    try:
        for loaded in (extra["encoder"], {}):
            jax_ckpt.overlay_params(params["encoder"], loaded, "encoder",
                                    strict=False, log=jlog)
    finally:
        jlog.removeHandler(jhandler)
    assert handler.lines == jhandler.lines == [
        "encoder: dropping unexpected checkpoint entry /stale",
        "encoder: checkpoint lacks /layers; keeping fresh init"]


def test_round1_pickle_checkpoint_loads_as_jax(tmp_path):
    """A round-1 (pickle) checkpoint, as the JAX package's migration test
    writes one (its OptimizerLeaves included), reads to the same payload
    and encodes; nothing beyond numpy and builtins is imported."""
    cfg, params = small_model(hidden=4, k=3, feature_dim=5)
    v2 = write_jax_checkpoint(tmp_path, cfg, params)
    payload = jax_ckpt.load_checkpoint(v2)
    payload["optimizer"] = jax_ckpt.OptimizerLeaves(
        [np.asarray(3, np.int32), np.asarray(0.5, np.float32)])
    path = tmp_path / "v1" / "checkpoint.pt"
    path.parent.mkdir()
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    got = port_ckpt.load_checkpoint(str(path))
    want = jax_ckpt.load_checkpoint(str(path))
    assert isinstance(got["optimizer"], port_ckpt.OptimizerLeaves)
    assert [float(v) for v in got["optimizer"].leaves] == [3.0, 0.5]
    assert got["encoder_init_parameters"] == want["encoder_init_parameters"]
    for g, w in zip(_leaves(got["encoder"]), _leaves(want["encoder"])):
        np.testing.assert_array_equal(g, w)
    enc = Encoder(str(path), device="cpu")
    assert enc.params["encoder"][0]["w_ih"].shape == (2, 65, 16)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_round1_pickle_naming_other_code_is_refused(tmp_path):
    module = "json.tool"
    assert module not in sys.modules
    path = tmp_path / "evil.pt"
    path.write_bytes(b"c" + module.encode() + b"\nmain\n(tR.")
    with pytest.raises(port_ckpt.UnsupportedPickle, match="json.tool.main"):
        port_ckpt.load_checkpoint(str(path))
    assert module not in sys.modules
    buf = io.BytesIO()
    pickle.dump({"w": torch.zeros(2)}, buf)
    path.write_bytes(buf.getvalue())
    with pytest.raises(port_ckpt.UnsupportedPickle, match="torch"):
        port_ckpt.load_checkpoint(str(path))


@pytest.mark.parametrize("name,value", [("SEQ2SEQ_BUCKET_POLICY", "dp"),
                                        ("SEQ2SEQ_NUM_BUCKETS", "4")])
def test_bucket_overrides_are_refused(monkeypatch, name, value):
    ds = AnnotationParser(TOY, os.path.join(
        TOY, "annotation_20170806-080002_89.2-94.22.csv")).get_data()
    DataLoader(ds, FrontendSpec(128, 64), batch_size=4)
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=name):
        DataLoader(ds, FrontendSpec(128, 64), batch_size=4)


# ---- the precision switches and --matmul_precision in the three CLIs

class _Built(Exception):
    """Raised by a stand-in for the model a CLI builds once its flags and
    environment have been read."""


def _run_cli(monkeypatch, cli, device, extra=()):
    """Run CLI ``cli`` with ``-d device`` up to the model it builds (a
    stand-in that records torch's float32 matmul precision and raises)."""
    seen = {}

    def built(*args, **kwargs):
        seen["precision"] = torch.get_float32_matmul_precision()
        raise _Built

    for module, name in ((learning_main, "Learner"),
                         (encode_main, "Encoder"),
                         (serve_main, "EncodeService")):
        monkeypatch.setattr(module, name, built)
    ann = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
    argv = {"learning": [TOY, ann, "-S", os.getcwd(), "-j", "r"],
            "encode": ["ckpt.pt", TOY, ann, "11.0"],
            "serve": ["ckpt.pt", "11.0", "16000"]}[cli]
    main = {"learning": learning_main.main,
            "encode": lambda a: encode_main.main("probs", a),
            "serve": serve_main.main}[cli]
    with pytest.raises(_Built):
        main(argv + ["-d", device, *extra])
    return seen["precision"]


@pytest.fixture
def matmul_precision_kept():
    """torch's float32 matmul precision, restored after the test."""
    before = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(before)


# (variable, the CLIs whose results it changes in the JAX package)
BF16_SWITCHES = [("SEQ2SEQ_KERNEL_MXU", ("learning", "encode", "serve")),
                 ("SEQ2SEQ_STREAM_DTYPE", ("learning",)),
                 ("SEQ2SEQ_ENCODE_FETCH_DTYPE", ("encode", "serve"))]


@pytest.mark.parametrize("cli", ["learning", "encode", "serve"])
@pytest.mark.parametrize("name,clis", BF16_SWITCHES)
def test_bf16_switches_are_refused(monkeypatch, tmp_path, cli, name, clis,
                                   matmul_precision_kept):
    """Fault 6: each bf16 switch of the JAX package is refused, naming the
    variable, by each CLI whose result it changes there, and ignored by
    the others, as there.  SEQ2SEQ_KERNEL_MXU=bf16 acts only with a
    --matmul_precision other than highest / float32 (JAX
    models/rnn.py:57)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(name, "bf16")
    mxu = name == "SEQ2SEQ_KERNEL_MXU"
    refused = ["--matmul_precision", "bfloat16"] if mxu else []
    if cli in clis:
        with pytest.raises(NotImplementedError, match=name):
            _run_cli(monkeypatch, cli, "cpu", refused)
    else:
        _run_cli(monkeypatch, cli, "cpu", refused)
    if mxu:
        _run_cli(monkeypatch, cli, "cpu", ["--matmul_precision", "highest"])
    monkeypatch.setenv(name, "f32")
    _run_cli(monkeypatch, cli, "cpu", refused)


# the JAX CLI's names and the torch precision each becomes on the card
MATMUL_PRECISION = {"highest": "highest", "float32": "highest",
                    "bfloat16_3x": "high", "default": "high",
                    "bfloat16": "medium"}


@pytest.mark.parametrize("cli", ["learning", "encode", "serve"])
@pytest.mark.parametrize("name", sorted(MATMUL_PRECISION))
def test_matmul_precision_means_the_same_in_every_cli(
        monkeypatch, tmp_path, cli, name, matmul_precision_kept):
    """Fault 7: one mapping of --matmul_precision, applied by all three
    CLIs on the card; on the CPU no CLI changes torch's precision."""
    monkeypatch.chdir(tmp_path)
    torch.set_float32_matmul_precision("highest")
    got = _run_cli(monkeypatch, cli, "cuda", ["--matmul_precision", name])
    assert got == MATMUL_PRECISION[name]
    torch.set_float32_matmul_precision("highest")
    assert _run_cli(monkeypatch, cli, "cpu",
                    ["--matmul_precision", name]) == "highest"
