"""The in-kernel decoder noise of the port (the JAX package's
``SEQ2SEQ_KERNEL_RNG=1``): a (1, 1) seed in place of the (T, B, F) noise
stream of the fused-loss decoder loops, and ``decoder_noise_dump``, the
stream that seed stands for.

The TPU's own random bits cannot be had on a GPU, so the port's stream is
its own (Philox4x32-10 of counter (t, b, f, 0) and key (seed, 0), then
the TPU kernel's Box-Muller).  Held here: the generator's twin against
Random123's known-answer vectors; the seed-mode losses and gradients of
every cell against the JAX package's ``decoder_apply(loss_only=True)`` on
its scan path fed the port's dump as its noise (the JAX interpret-mode
kernels lack ``prng_seed``); the seed mode against the stream mode fed the
dump; the seed refused where the JAX package never takes one; the
training CLI's reading of the variable and a seeded training run on the
CPU.  The twins are what the wrappers run on CPU tensors and what the
card's kernels are held to (tests/test_torch_port_gpu.py)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu import distributions as jax_dist
from seq2seq_abcd_vae_tpu.configs import DecoderConfig as JaxDecoderConfig
from seq2seq_abcd_vae_tpu.models import decoder as jax_decoder
from seq2seq_abcd_vae_tpu_torch.cli import flags, learning_main
from seq2seq_abcd_vae_tpu_torch.configs import DecoderConfig
from seq2seq_abcd_vae_tpu_torch.models import decoder as port_decoder
from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
from seq2seq_abcd_vae_tpu_torch.train import learner as port_learner
from seq2seq_abcd_vae_tpu_torch.train.from_jax import _to_np
from seq2seq_abcd_vae_tpu_torch.tree import tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 reference_jit)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
CSV = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
# float32 sums in another order through at most 9 recurrent steps: the
# losses to 1e-5 relative; each gradient leaf to 1e-4 of its largest
# magnitude (a leaf sums every step's and row's contribution).
LOSS_RTOL = 1e-5
GRAD_FRACTION = 1e-4
CELL_LEAK = {"LSTM": 1.0, "GRU": 1.0, "RNN": 1.0, "ESN": 0.5}
SPEAKERS = 3


def _words(*values):
    return tuple(torch.tensor(v, dtype=torch.int64) for v in values)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_twin_gives_random123_known_answers(counter, key, want):
    """(i) Philox4x32-10's known-answer vectors (Random123's kat_vectors)."""
    got = dk.philox4x32(_words(*counter), _words(*key))
    assert tuple(int(w) for w in got) == want


def test_dump_twin_follows_its_formula():
    """Element (t, b, f) is the Box-Muller of the top 24 bits of the first
    two Philox words of counter (t, b, f, 0), key (seed, 0); slots, rows,
    columns and seeds give different draws; the normals have mean 0 and
    variance 1 within 5 standard errors."""
    seed = torch.tensor([[9876543.0]])
    out, bits = dk.decoder_noise_dump(seed, 12, 6, 5, with_bits=True)
    assert out.shape == (12, 6, 5) and out.dtype == torch.float32
    assert bits.shape == (12, 6, 5, 2) and bits.dtype == torch.int32
    w = dk.philox4x32(_words(7, 4, 3, 0), _words(9876543, 0))
    assert (int(bits[7, 4, 3, 0]), int(bits[7, 4, 3, 1])) == (
        int(w[0]) >> 8, int(w[1]) >> 8)
    u1 = np.float32(int(w[0]) >> 8) * np.float32(2.0 ** -24) + np.float32(
        2.0 ** -25)
    u2 = np.float32(int(w[1]) >> 8) * np.float32(2.0 ** -24)
    want = np.sqrt(-2.0 * np.log(np.float64(u1))) * np.cos(
        2.0 * np.pi * np.float64(u2))
    assert abs(float(out[7, 4, 3]) - want) <= 2e-6
    assert not torch.equal(out[0], out[1])
    assert not torch.equal(out, dk.decoder_noise_dump(seed + 1, 12, 6, 5))
    big = dk.decoder_noise_dump(torch.tensor([[5.0]]), 40, 50, 30).double()
    n = big.numel()
    assert abs(big.mean().item()) <= 5.0 / np.sqrt(n)
    assert abs(big.var().item() - 1.0) <= 5.0 * np.sqrt(2.0 / n)


def _case(rng, cell, t=9, f=5, h=8, m=6, feat=5, embed=4,
          lens=(9, 0, 4, 1, 7)):
    """Configs of both packages, port-drawn weights as numpy, features,
    lengths, speakers, padded targets, the (t == len - 1) offsets and a
    seed below 2^24."""
    kw = dict(num_speakers=SPEAKERS, speaker_embed_dim=embed, rnn_type=cell,
              esn_leak=CELL_LEAK[cell])
    jcfg, pcfg = (JaxDecoderConfig(f, h, m, feat, **kw),
                  DecoderConfig(f, h, m, feat, **kw))
    params = tree_map(_to_np, port_decoder.decoder_init(
        torch.Generator().manual_seed(3), pcfg))
    lens = np.asarray(lens, np.int32)
    b = len(lens)
    features = rng.normal(size=(b, feat)).astype(np.float32)
    speakers = np.asarray([0, -1, 2, 1, 0][:b], np.int32)
    valid = np.arange(t)[None, :] < lens[:, None]
    gt = (rng.normal(size=(b, t, f)) * valid[..., None]).astype(np.float32)
    is_offset = (np.arange(t)[None, :] == lens[:, None] - 1).astype(
        np.float32)
    seed = np.asarray([[rng.integers(0, 1 << 24)]], np.float32)
    return jcfg, pcfg, params, features, lens, speakers, gt, is_offset, seed


def _port_losses(pcfg, params, features, lens, gt, noise, speakers,
                 **kwargs):
    leaves = tree_map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), params)
    feats = torch.from_numpy(features).requires_grad_(True)
    out = port_decoder.decoder_losses(
        leaves, pcfg, feats, torch.from_numpy(lens), torch.from_numpy(gt),
        torch.from_numpy(noise), speaker=torch.from_numpy(speakers),
        **kwargs)
    return out, leaves, feats


def _assert_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= GRAD_FRACTION * scale, name


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "RNN", "ESN"])
def test_seed_mode_matches_jax_fed_the_dump(rng, monkeypatch, cell):
    """(ii) decoder_losses with a (1, 1) seed (the fused-loss twins after
    the dump's twin) against the JAX package's decoder_apply(loss_only=True)
    on its scan path, whose noise draw is replaced by the port's dump of
    that seed: both losses and every leaf's gradient."""
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg, params, features, lens, speakers, gt, is_offset, seed = (
        _case(rng, cell))
    b, t, f = gt.shape
    dump = dk.decoder_noise_dump(torch.from_numpy(seed), t, b, f).numpy()
    gaussian = jax_dist.choose_distribution("isotropic_gaussian")
    monkeypatch.setitem(
        jax_dist._REGISTRY, "isotropic_gaussian", gaussian._replace(
            noise=lambda key, shape, dtype=jnp.float32: jnp.asarray(
                dump, dtype)))
    key = jax.random.PRNGKey(3)

    def jax_loss(p, feats):
        out = jax_decoder.decoder_apply(
            p, jcfg, feats, jnp.asarray(lens), t,
            speaker=jnp.asarray(speakers), ground_truth_out=jnp.asarray(gt),
            ground_truth_offset=jnp.asarray(is_offset), key=key,
            loss_only=True)
        return (0.7 * out.emission_loss + 1.3 * out.offset_loss,
                (out.emission_loss, out.offset_loss))

    with jax.default_matmul_precision("highest"):
        (_, (want_em, want_off)), (g_p, g_feat) = reference_jit(
            jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
                params, jnp.asarray(features))
    (em, off), leaves, feats = _port_losses(pcfg, params, features, lens, gt,
                                            seed, speakers)
    np.testing.assert_allclose(em.item(), float(want_em), rtol=LOSS_RTOL)
    np.testing.assert_allclose(off.item(), float(want_off), rtol=LOSS_RTOL)
    (0.7 * em + 1.3 * off).backward()
    _assert_close(feats.grad.numpy(), g_feat, "features")
    got_flat = jax.tree_util.tree_leaves_with_path(leaves)
    want_flat = jax.tree_util.tree_leaves(g_p)
    assert len(got_flat) == len(want_flat)
    for (path, leaf), want in zip(got_flat, want_flat):
        name = jax.tree_util.keystr(path)
        if cell == "ESN" and "rnn_cell" in name:
            assert leaf.grad is None, name  # the frozen reservoir
            np.testing.assert_array_equal(np.asarray(want), 0.0)
        else:
            _assert_close(leaf.grad.numpy(), want, name)


def _fused_args(rng, cell, t=7, b=5, f=4, h=6, m=3, mo=5):
    """A fused-loss loop's arguments (the seed first) as tensors."""
    gh = {"LSTM": 4, "GRU": 3}.get(cell, 1) * h

    def uni(bound, *shape):
        return torch.from_numpy(rng.uniform(-bound, bound, size=shape)
                                .astype(np.float32))
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32))
    args = [torch.tensor([[float(rng.integers(0, 1 << 24))]]),
            torch.tensor([t, 0, 3, 1, 6][:b], dtype=torch.int32),
            uni(0.4, h, gh + 2 * m)]
    if cell == "GRU":
        args += [uni(0.4, gh), uni(0.4, gh)]
    else:
        args.append(torch.zeros(gh) if cell == "ESN" else uni(0.5, gh))
    args += [uni(0.4, 2 * m), uni(0.4, m, f), uni(0.4, m, f),
             uni(0.4, 2 * f), uni(0.4, f, gh), normal(t, b, f),
             uni(0.4, h, mo), uni(0.4, mo), uni(0.4, mo), uni(0.4, 1)]
    args += [normal(b, h) * 0.5 for _ in range(2 if cell == "LSTM" else 1)]
    return args


FUSED = {"LSTM": dk.decoder_loop_fused_losses,
         "GRU": dk.gru_decoder_loop_fused_losses,
         "RNN": dk.rnn_decoder_loop_fused_losses,
         "ESN": dk.rnn_decoder_loop_fused_losses}


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "RNN", "ESN"])
def test_seed_mode_equals_stream_mode_fed_the_dump(rng, cell):
    """(iii) Each fused-loss loop in seed mode equals the same loop fed the
    dump of that seed: outputs and every gradient, bit for bit on the CPU
    (the same twin after the same dump); the seed gets no gradient."""
    args = _fused_args(rng, cell)
    kw = {"leak": CELL_LEAK[cell]} if cell in ("RNN", "ESN") else {}
    t, b, f = args[10 if cell == "GRU" else 9].shape
    dump = dk.decoder_noise_dump(args[0], t, b, f)

    def run(noise):
        leaves = [a.clone().requires_grad_(a.dtype == torch.float32)
                  for a in args[1:]]
        out = FUSED[cell](noise, *leaves, **kw)
        (out[0].sum() * 0.3 + out[1] * 0.7 + out[2] * 1.3).backward()
        return out, [None if x.grad is None else x.grad for x in leaves]

    seed = args[0].clone().requires_grad_(True)
    (got, got_g), (want, want_g) = run(seed), run(dump)
    assert seed.grad is None
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got_g, want_g):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("cell,fused_cells,with_offset", [
    ("GRU", (), True), ("LSTM", (), True), ("LSTM", port_decoder.CELLS,
                                            False)])
def test_a_seed_off_the_fused_losses_path_is_refused(rng, cell, fused_cells,
                                                     with_offset):
    """The JAX package draws a seed only for the fused-loss call; the
    stream path and the fused-NLL call (no offset targets) take the
    (T, B, F) stream, and a seed there is a ValueError."""
    _, pcfg, params, features, lens, speakers, gt, _, seed = _case(rng,
                                                                   cell)
    with pytest.raises(ValueError, match="seed"):
        _port_losses(pcfg, params, features, lens, gt, seed, speakers,
                     fused_cells=fused_cells, with_offset=with_offset)
    args = _fused_args(rng, "LSTM")
    loop_args = args[:9] + args[14:]
    with pytest.raises(ValueError, match="noise must be"):
        dk.decoder_loop(*loop_args)


def test_cli_honours_kernel_rng_on_the_card_only(monkeypatch, tmp_path):
    """(v) The training CLI reads SEQ2SEQ_KERNEL_RNG once, beside the
    fused cells; as the JAX package honours it on its accelerator only,
    the port honours it with -d cuda and ignores it with -d cpu."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_learner(**kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(learning_main, "Learner", fake_learner)
    monkeypatch.setenv("SEQ2SEQ_KERNEL_RNG", "1")
    for device, want in (("cpu", False), ("cuda", True)):
        with pytest.raises(Stop):
            learning_main.main([TOY, CSV, "-S", str(tmp_path), "-j", "r",
                                "-d", device])
        assert seen["kernel_rng"] is want, device
    assert not flags.kernel_rng({"SEQ2SEQ_KERNEL_RNG": "0"}, "cuda")
    assert not flags.kernel_rng({}, "cuda")


def test_seeded_training_runs_and_draws_the_seed(monkeypatch, tmp_path):
    """A Learner with kernel_rng on draws, Gumbel first, a (1, 1) float32
    seed below 2^24 for a fused decoder and the (T, B, F) stream for a
    decoder on the stream path, in training and validation steps; a
    seeded run trains to finite losses on the CPU twins."""
    drawn = []
    draw = port_learner.draw_noise

    def spy(gen, cfg, rows, frames, device, seed=False):
        out = draw(gen, cfg, rows, frames, device, seed=seed)
        drawn.append(tuple(out["decoder"].shape))
        if seed:
            v = out["decoder"]
            assert v.dtype == torch.float32 and 0 <= v.item() < 2 ** 24
            assert v.item() == int(v.item())
        return out

    monkeypatch.setattr(port_learner, "draw_noise", spy)
    (tmp_path / "rng").mkdir()
    learner = port_learner.Learner(
        input_size=65, encoder_rnn_hidden_size=6, decoder_rnn_hidden_size=6,
        mlp_hidden_size=6, num_feature_categories=4, feature_dim=5,
        save_dir=str(tmp_path / "rng"), device="cpu", kernel_rng=True,
        encoder_rnn_type="GRU", decoder_rnn_type="GRU")
    from seq2seq_abcd_vae_tpu_torch.data.annotations import AnnotationParser
    from seq2seq_abcd_vae_tpu_torch.data.batching import FrontendSpec
    parser = AnnotationParser(TOY, CSV)
    learner.learn(parser.get_data(data_type="train"),
                  parser.get_data(data_type="valid"), 1, 4, 4,
                  frontend=FrontendSpec(128, 64), data_normalizer=11.0,
                  pretrain_epochs=1)
    assert drawn and set(drawn) == {(1, 1)}
    steps = learner.steps["train"] + learner.steps["eval"]
    assert len(drawn) == steps >= 2
    with open(os.path.join(str(tmp_path / "rng"), "history.log")) as f:
        log = f.read()
    assert "mean training total loss" in log and "nan" not in log.lower()
    statics = port_learner.StepStatics(learner.model_cfg, 128, 64, "hann",
                                       1e-5, 11.0, kernel_rng=True,
                                       fused_cells=("LSTM",))
    assert not statics.decoder_seed  # the GRU decoder on the stream path
