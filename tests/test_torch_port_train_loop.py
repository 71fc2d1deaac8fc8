"""The port's training loop on the CPU: the annotation reader and the
batches it makes against the JAX package's (pandas) reader and loader,
the training CLI end to end with resume, and checkpoints crossing both
ways: a checkpoint written by the JAX package resumes in the port, and
the port's loads through the JAX package's load_checkpoint to the same
arrays, its optimiser leaves fitting the JAX optimiser's state.  The JAX
Learner and Encoder are never built here (they set process-wide state)."""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax

from seq2seq_abcd_vae_tpu.configs import (
    ABCDSamplerConfig as JaxABCDConfig, DecoderConfig as JaxDecoderConfig,
    EncoderConfig as JaxEncoderConfig)
from seq2seq_abcd_vae_tpu.data.annotations import (
    AnnotationParser as JaxAnnotationParser)
from seq2seq_abcd_vae_tpu.data.batching import (DataLoader as JaxDataLoader,
                                                FrontendSpec as JaxFrontend)
from seq2seq_abcd_vae_tpu.models import vae as jax_vae
from seq2seq_abcd_vae_tpu.train import checkpoint as jax_ckpt
from seq2seq_abcd_vae_tpu.train import optim as jax_optim
from seq2seq_abcd_vae_tpu_torch.cli import learning_main
from seq2seq_abcd_vae_tpu_torch.data.annotations import AnnotationParser
from seq2seq_abcd_vae_tpu_torch.data.batching import DataLoader, FrontendSpec
from seq2seq_abcd_vae_tpu_torch.infer.encode import Encoder, encode_step
from seq2seq_abcd_vae_tpu_torch.train.from_jax import params_to_jax
from seq2seq_abcd_vae_tpu_torch.train.learner import Learner
from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_unflatten
from torch_port_fixtures import (BINS, EPS, NORMALIZER,
                                 few_torch_threads_fixture, port_init_tree)

few_torch_threads = pytest.fixture(few_torch_threads_fixture)
pytestmark = pytest.mark.usefixtures("few_torch_threads")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
CSV = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
TOY_WIDTH = ["-K", "6", "-f", "10", "--encoder_rnn_hidden_size", "8",
             "--decoder_rnn_hidden_size", "8", "--mlp_hidden_size", "12",
             "--speaker_embed_dim", "3", "-N", str(NORMALIZER)]


def test_annotations_and_batches_match_jax():
    jp = JaxAnnotationParser(TOY, CSV)
    pp = AnnotationParser(TOY, CSV)
    assert pp.speaker2ix == jp.speaker2ix
    assert pp.get_sample_freq() == jp.get_sample_freq() == 16000
    spec = (128, 64)
    for data_type in ("train", "valid", None):
        jd, pd_ = jp.get_data(data_type), pp.get_data(data_type)
        for name in ("index_labels", "onsets_np", "offsets_np",
                     "lengths_np", "speakers_np"):
            np.testing.assert_array_equal(getattr(pd_, name),
                                          getattr(jd, name), name)
    for mode in ("bucket_shuffled", "length_sorted", "uniform"):
        jl = JaxDataLoader(jp.get_data("train"), JaxFrontend(*spec),
                           batch_size=2, shuffle=True, batching_mode=mode,
                           pad_to_batch_size=False)
        pl_ = DataLoader(pp.get_data("train"), FrontendSpec(*spec),
                         batch_size=2, shuffle=True, batching_mode=mode)
        assert pl_.bucket_edges == jl.bucket_edges
        for _ in range(2):  # two epochs: the shuffle advances alike
            for jb, pb in zip(jl, pl_, strict=True):
                assert pb.ixs == [int(i) for i in jb.ixs]
                assert pb.bucket_frames == jb.bucket_frames
                np.testing.assert_array_equal(pb.audio, jb.audio)
                np.testing.assert_array_equal(pb.num_frames, jb.num_frames)
                np.testing.assert_array_equal(pb.speakers, jb.speakers)


def _history(save_dir):
    with open(os.path.join(save_dir, "history.log")) as f:
        return f.read()


def test_cli_trains_resumes_and_encodes(tmp_path):
    argv = [TOY, CSV, "-S", str(tmp_path), "-j", "run", "-b", "4",
            "--pretrain_epochs", "1", "-d", "cpu", "-M", "0.9",
            "--stft_method", "pallas"] + TOY_WIDTH
    first = learning_main.main(argv + ["-e", "2"])
    run = tmp_path / "run"
    log = _history(run)
    assert "END OF PRETRAINING." in log and log.rstrip().endswith(
        "END OF TRAINING")
    losses = re.findall(r"mean loss: (\S+)\.\s", log)
    assert len(losses) == 4  # 2 batches of the 5 train rows, 2 epochs
    assert all(math.isfinite(float(v)) for v in re.findall(
        r"total loss \(per string\): (\S+)", log))
    assert first.steps == {"train": 4, "eval": 2}
    assert (run / "checkpoint.pt").is_file()
    assert (run / "speaker_coding.json").read_text() == '{"a": 0, "b": 1}'

    again = learning_main.main(argv + ["-e", "3"])
    log = _history(run)
    assert "LEARNING RETRIEVED." in log
    assert "To be restarted from the beginning of epoch #: 3" in log
    assert again.steps == {"train": 2, "eval": 1}
    assert again.step_count == 6  # the optimiser's count carried over

    # the trained checkpoint encodes through the port's serving Encoder
    enc = Encoder(str(run / "checkpoint.pt"), device="cpu",
                  stft_method="pallas")
    loader = DataLoader(AnnotationParser(TOY, CSV).get_data(None),
                        FrontendSpec(128, 64), batch_size=7)
    batch = next(iter(loader))
    st = enc.statics(FrontendSpec(128, 64), EPS, NORMALIZER)
    probs = encode_step(enc.params, torch.from_numpy(batch.audio),
                        torch.from_numpy(batch.num_frames), st,
                        batch.bucket_frames, "probs")
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)

    # ... and loads through the JAX package's reader to the same arrays
    c = jax_ckpt.load_checkpoint(str(run / "checkpoint.pt"))
    mine = params_to_jax(again.params)
    for name in ("encoder", "feature_sampler", "decoder"):
        got = jax.tree_util.tree_leaves_with_path(c[name])
        want = jax.tree_util.tree_leaves(mine[name])
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            np.testing.assert_array_equal(g, w, jax.tree_util.keystr(path))
    tx = jax_optim.make_optimizer(1.0, 0.9, 1.0)
    template = tx.init(c_params := {k: c[k] for k in (
        "encoder", "feature_sampler", "decoder")})
    leaves = c["optimizer"].leaves
    state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves)
    assert int(state.count) == 6
    for a, b in zip(jax.tree_util.tree_leaves(template),
                    jax.tree_util.tree_leaves(state)):
        assert np.shape(a) == np.shape(b)
    assert jax.tree_util.tree_structure(c_params) == \
        jax.tree_util.tree_structure(mine)
    sched = jax_optim.ReduceLROnPlateau()
    sched.load_state_dict(c["lr_scheduler"])
    assert sched.last_epoch == 3


def test_jax_checkpoint_resumes_in_port(tmp_path, rng):
    enc = JaxEncoderConfig(BINS, 8)
    cfg = jax_vae.ModelConfig(
        enc, JaxABCDConfig(enc.hidden_size_total, 12, 6, 10),
        JaxDecoderConfig(BINS, 8, 12, 10))
    params = port_init_tree(cfg, 0)
    momentum = 0.9
    tx = jax_optim.make_optimizer(0.25, momentum, 1.0)
    state = tx.init(params)
    leaves = jax.tree_util.tree_leaves(state)
    traces = [rng.normal(size=np.shape(a)).astype(np.float32)
              for a in leaves[2:]]
    opt_leaves = [np.int32(17), np.float32(0.25)] + traces
    sched = jax_optim.ReduceLROnPlateau(patience=2)
    sched.step(3.0, 1.0)
    payload = {
        "epoch": 1, "latent_type": "abcd",
        "encoder": params["encoder"],
        "encoder_init_parameters": cfg.encoder.pack_init_parameters(),
        "feature_sampler": params["feature_sampler"],
        "feature_sampler_init_parameters": dict(
            cfg.latent.pack_init_parameters(), epoch_init_iter_counts=5),
        "decoder": params["decoder"],
        "decoder_init_parameters": cfg.decoder.pack_init_parameters(),
        "optimizer": jax_ckpt.OptimizerLeaves(opt_leaves),
        "momentum": momentum,
        "lr_scheduler": sched.state_dict(),
        "gradient_clip": 1.0,
        "random_state": np.asarray(jax.random.PRNGKey(3)),
    }
    jax_ckpt.save_checkpoint(str(tmp_path), payload)
    (tmp_path / "history.log").write_text("")  # the resume marker

    learner = Learner(save_dir=str(tmp_path), device="cpu")
    assert learner.retrieval and learner.last_epoch == 1
    assert learner.iter_counts == 5
    got = params_to_jax(learner.params)
    for name in ("encoder", "feature_sampler", "decoder"):
        for g, w in zip(jax.tree_util.tree_leaves(got[name]),
                        jax.tree_util.tree_leaves(params[name]),
                        strict=True):
            np.testing.assert_array_equal(g, w)
    parser = AnnotationParser(TOY, CSV)
    # num_epochs == the saved epoch: restore the optimiser, train nothing
    learner.learn(parser.get_data("train"), parser.get_data("valid"), 1, 4,
                  4, FrontendSpec(128, 64), pretrain_epochs=0)
    assert learner.step_count == 17
    assert learner.optimizer.param_groups[0]["lr"] == pytest.approx(0.25)
    assert learner.lr_scheduler.state_dict() == sched.state_dict()
    buffers = [learner.optimizer.state[p]["momentum_buffer"]
               for p in tree_leaves(learner.params)]
    got_traces = tree_leaves(params_to_jax(tree_unflatten(learner.params,
                                                          buffers)))
    for g, w in zip(got_traces, traces, strict=True):
        np.testing.assert_array_equal(g, w)
