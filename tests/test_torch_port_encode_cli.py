"""The port's offline encode CLI (``cli/encode_main.py`` ->
``infer/encode.Encoder.encode_dataset``) against the JAX package's, on
``fixtures/toy_data/`` and checkpoints written by the JAX package.

The JAX encode CLI runs once, in a subprocess (it builds a JAX
``Encoder``, which sets process-wide JAX state); the other modes are held
to the JAX package's pure pieces in-process: its loader, ``_encode_step``
and its CSV formatting (``_annotation_suffixes``, ``_format_rows``).
Values agree to float32 tolerance (float32 products in another order
through the encoder and the head); every other byte is equal."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.configs import (ABCDSamplerConfig, DecoderConfig,
                                          EncoderConfig)
from seq2seq_abcd_vae_tpu.data.annotations import (
    AnnotationParser as JaxParser)
from seq2seq_abcd_vae_tpu.data.batching import DataLoader as JaxLoader
from seq2seq_abcd_vae_tpu.data.batching import FrontendSpec as JaxFrontend
from seq2seq_abcd_vae_tpu.infer.encode import (_annotation_suffixes,
                                               _encode_step, _format_rows)
from seq2seq_abcd_vae_tpu.models import vae
from seq2seq_abcd_vae_tpu.train.learner import StepStatics as JaxStatics
from seq2seq_abcd_vae_tpu_torch.cli import encode_main
from torch_port_fixtures import (EPS, FRAME, NORMALIZER, STEP,
                                 few_torch_threads_fixture, one_step_scans,
                                 port_init_tree, small_model,
                                 write_jax_checkpoint)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
ANN = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
VALUE_COL = {"probs": "prob", "logits": "logit", "features": "feature_value"}
# probabilities of K=6 categories: float32 rounding of a softmax; logits
# and features are O(1) sums of float32 products
TOL = {"probs": 1e-6, "logits": 1e-5, "features": 1e-5}

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)


@pytest.fixture(autouse=True)
def scan_backends(monkeypatch):
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)


def _uni_model(hidden=8, k=6, feature_dim=10, mlp_hidden=12, seed=3):
    enc = EncoderConfig(FRAME // 2 + 1, hidden, bidirectional=False)
    lat = ABCDSamplerConfig(enc.hidden_size_total, mlp_hidden, k,
                            feature_dim)
    dec = DecoderConfig(FRAME // 2 + 1, hidden, mlp_hidden, feature_dim)
    cfg = vae.ModelConfig(enc, lat, dec)
    return cfg, port_init_tree(cfg, seed)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    out = {}
    for name, (cfg, params) in (("bidir", small_model(hidden=8, k=6)),
                                ("uni", _uni_model())):
        path = write_jax_checkpoint(tmp_path_factory.mktemp(name), cfg,
                                    params)
        out[name] = (cfg, params, path)
    return out


def _jax_csv(cfg, params, mode, batch_size) -> bytes:
    """The JAX encode writer's bytes, from its own loader, step and
    formatting (what ``Encoder.encode_dataset`` assembles)."""
    parser = JaxParser(TOY, ANN)
    ds = parser.get_data()
    loader = JaxLoader(ds, JaxFrontend(FRAME, STEP), batch_size=batch_size,
                       pad_to_batch_size=False)
    df_ann = ds.df_annotation.drop(columns=["onset_ix", "offset_ix",
                                            "length"])
    var_col = "category_ix" if mode == "probs" else "dimension"
    text = (",".join(["data_ix", var_col, VALUE_COL[mode]]
                     + [str(c) for c in df_ann.columns]) + "\n").encode()
    suffix = _annotation_suffixes(df_ann)
    statics = JaxStatics(cfg, FRAME, STEP, "hann_window", EPS, NORMALIZER)
    sub = {k: params[k] for k in ("encoder", "feature_sampler")}
    with jax.default_matmul_precision("highest"):
        for batch in loader:
            out = np.asarray(_encode_step(
                sub, jnp.asarray(batch.audio), jnp.asarray(batch.num_frames),
                statics=statics, bucket_frames=batch.bucket_frames,
                mode=mode))[:batch.num_real]
            text += _format_rows(batch.ixs, out, suffix, {})
    return text


def _port_cli(mode, path, save, *extra):
    encode_main.main(mode, [path, TOY, ANN, str(NORMALIZER), "-S", str(save),
                            "-d", "cpu", *extra])


def _split(text: bytes):
    """(header, [(data_ix, var, rest)], values float64) of a long CSV."""
    lines = text.decode().splitlines()
    rows = [line.split(",", 3) for line in lines[1:]]
    keys = [(r[0], r[1], r[3] if len(r) > 3 else None) for r in rows]
    return lines[0], keys, np.asarray([float(r[2]) for r in rows])


def _assert_csv_match(got: bytes, want: bytes, mode: str):
    g_head, g_keys, g_vals = _split(got)
    w_head, w_keys, w_vals = _split(want)
    assert g_head == w_head
    assert g_keys == w_keys  # data_ix, var and annotation bytes equal
    np.testing.assert_allclose(g_vals, w_vals, rtol=0, atol=TOL[mode])


def test_probs_csv_matches_jax_cli(tmp_path, checkpoints):
    """The acceptance case: both packages' encode CLIs on the toy corpus
    from one JAX-written checkpoint; the JAX one in a subprocess."""
    _, _, path = checkpoints["bidir"]
    want_path = tmp_path / "jax.csv"
    # one CPU device and few threads: the suite runs beside it
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SEQ2SEQ_ABCD_VAE_NO_COMPILE_CACHE="1", SEQ2SEQ_SCAN_UNROLL="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=2")
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "ABCD-VAE", "encode.py"), path,
         TOY, ANN, str(NORMALIZER), "-S", str(want_path), "-b", "3", "-d",
         "cpu"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    got_path = tmp_path / "port.csv"
    _port_cli("probs", path, got_path, "-b", "3")
    got, want = got_path.read_bytes(), want_path.read_bytes()
    _assert_csv_match(got, want, "probs")
    _, keys, vals = _split(got)
    assert len(keys) == 8 * 6  # segments x K
    sums = {}
    for (ix, _, _), v in zip(keys, vals):
        sums[ix] = sums.get(ix, 0.0) + v
    np.testing.assert_allclose(list(sums.values()), 1.0, atol=1e-5)


@pytest.mark.parametrize("mode,model,batch_size", [
    ("logits", "bidir", 4), ("features", "bidir", 1),
    ("features", "uni", 3), ("probs", "uni", 8)])
def test_csv_matches_jax_writer(tmp_path, checkpoints, mode, model,
                                batch_size):
    cfg, params, path = checkpoints[model]
    save = tmp_path / "out.csv"
    _port_cli(mode, path, save, "-b", str(batch_size))
    _assert_csv_match(save.read_bytes(),
                      _jax_csv(cfg, params, mode, batch_size), mode)


def test_npz_holds_the_csv_values(tmp_path, checkpoints):
    """The npz sidecar: data_ix in stream order, the mode, and values that
    the CSV's shortest-repr text parses back to bit for bit."""
    _, _, path = checkpoints["uni"]
    _port_cli("logits", path, tmp_path / "a.csv", "-b", "3")
    _port_cli("logits", path, tmp_path / "a.npz", "-b", "3",
              "--save_format", "npz")
    with np.load(tmp_path / "a.npz") as z:
        assert sorted(z.files) == ["data_ix", "mode", "values"]
        assert str(z["mode"]) == "logits"
        ixs, values = z["data_ix"], z["values"]
    assert ixs.dtype == np.int64 and values.dtype == np.float32
    assert values.shape == (8, 6)
    lines = (tmp_path / "a.csv").read_text().splitlines()[1:]
    parsed = {}
    for line in lines:
        ix, var, val = line.split(",")[:3]
        parsed[(int(ix), int(var))] = np.float32(val)
    back = np.asarray([[parsed[(int(ix), j)] for j in range(6)]
                       for ix in ixs], np.float32)
    assert back.tobytes() == values.tobytes()


def test_existing_results_are_kept_as_prev_chain(tmp_path, checkpoints):
    _, _, path = checkpoints["bidir"]
    save = tmp_path / "r.csv"
    save.write_text("first\n")
    _port_cli("features", path, save)
    (tmp_path / "keep").write_bytes(save.read_bytes())
    _port_cli("features", path, save)
    assert (tmp_path / "r.csv.prev.prev").read_text() == "first\n"
    assert ((tmp_path / "r.csv.prev").read_bytes()
            == (tmp_path / "keep").read_bytes() == save.read_bytes())


def test_unported_modes_and_options_are_refused(tmp_path, checkpoints):
    """params mode is the plain VAE's: an ABCD checkpoint is refused."""
    _, _, path = checkpoints["bidir"]
    with pytest.raises(ValueError, match="'params' needs a 'gaussian'"):
        _port_cli("params", path, tmp_path / "p.csv")
    with pytest.raises(NotImplementedError, match="corpus cache"):
        _port_cli("probs", path, tmp_path / "p.csv", "--device_corpus_cache",
                  "on")
    assert not (tmp_path / "p.csv").exists()


def test_module_entry_point_takes_the_mode_first(tmp_path, checkpoints):
    _, _, path = checkpoints["uni"]
    save = tmp_path / "m.csv"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    done = subprocess.run(
        [sys.executable, "-m", "seq2seq_abcd_vae_tpu_torch.cli.encode_main",
         "features", path, TOY, ANN, str(NORMALIZER), "-S", str(save),
         "-d", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert save.read_text().startswith(
        "data_ix,dimension,feature_value,onset,offset,input_path,data_type,"
        "speaker,label\n")
