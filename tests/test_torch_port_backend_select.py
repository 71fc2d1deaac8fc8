"""The port's kernel-backend selector and launch-cost probe
(``utils/backend_select.py``, ``ops/probe_kernel.py``) against the JAX
package's ``utils/backend_select.BackendSelector``, and the CLIs' reading
of the backend switches.

Each selector is built fresh with the same injected latencies (the port's
on platform ``cuda``, the JAX package's on ``tpu``; the JAX module-level
``SELECTOR`` is never touched), and every scenario of
tests/test_backend_select.py must give the same choices, decision trail
and report.  Where the port differs by design: a failing probe raises
instead of being recorded, and on the card any ``scan`` stops the run,
since the port's scan path, its plain twins, runs on the CPU only."""

import os

import pytest
import torch

from seq2seq_abcd_vae_tpu.utils.backend_select import (
    BackendSelector as JaxSelector)
from seq2seq_abcd_vae_tpu_torch.cli import encode_main, learning_main
from seq2seq_abcd_vae_tpu_torch.cli import serve_main
from seq2seq_abcd_vae_tpu_torch.ops import probe_kernel
from seq2seq_abcd_vae_tpu_torch.utils import backend_select
from seq2seq_abcd_vae_tpu_torch.utils.backend_select import BackendSelector
from torch_port_fixtures import few_torch_threads_fixture

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
CSV = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")


@pytest.fixture(autouse=True)
def _auto_mode(monkeypatch):
    monkeypatch.delenv("SEQ2SEQ_RNN_BACKEND", raising=False)
    monkeypatch.delenv("SEQ2SEQ_ENCODER_BACKEND", raising=False)
    monkeypatch.delenv("SEQ2SEQ_PALLAS_DISPATCH_MS_MAX", raising=False)


# Each scenario: calls in order, ("current", None) or ("reprobe", ms) with
# the latency set first; the scenarios of tests/test_backend_select.py.
SCENARIOS = {
    "latency_flip_switches_exactly_once": (
        [("current", 1.0)] + [("reprobe", 1.0)] * 3 + [("reprobe", 500.0)]
        + [("reprobe", 500.0)] * 5),
    "flip_back_allows_second_switch": [
        ("current", 1.0), ("reprobe", 500.0), ("reprobe", 1.0)],
    "hysteresis_band_never_flaps": (
        [("current", 1.0)] + [("reprobe", ms) for ms in
                              (25.0, 39.0, 15.0, 35.0, 41.0, 15.0, 11.0,
                               39.0, 9.0)]),
    "report_exposes_trail": [("current", 1.0), ("reprobe", 500.0)],
    "first_probe_above_the_limit": [("current", 20.0), ("reprobe", 9.999),
                                    ("reprobe", 10.0004)],
}


def _run(selector, box, steps):
    out = []
    for call, ms in steps:
        box["ms"] = ms
        out.append(selector.current() if call == "current"
                   else selector.maybe_reprobe(context="epoch"))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("limit", [None, "5"])
def test_selector_decides_as_the_jax_selector(monkeypatch, name, limit):
    """(iv) The same choices, trail and report as the JAX selector under
    the same injected latencies, at the default limit and at
    SEQ2SEQ_PALLAS_DISPATCH_MS_MAX=5."""
    if limit is not None:
        monkeypatch.setenv("SEQ2SEQ_PALLAS_DISPATCH_MS_MAX", limit)
    port_box, jax_box = {}, {}
    port = BackendSelector(lambda: port_box["ms"], "cuda")
    ref = JaxSelector(measure=lambda: jax_box["ms"], platform=lambda: "tpu")
    steps = SCENARIOS[name]
    assert _run(port, port_box, steps) == _run(ref, jax_box, steps)
    assert port.decisions == ref.decisions
    assert port.report() == ref.report()
    if name == "latency_flip_switches_exactly_once" and limit is None:
        assert [d["switched"] for d in port.decisions].count(True) == 1


@pytest.mark.parametrize("forced", ["scan", "pallas"])
def test_forced_mode_never_probes(monkeypatch, forced):
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", forced)

    def boom():
        raise AssertionError("a forced mode must not probe")

    port = BackendSelector(boom, "cuda")
    ref = JaxSelector(measure=boom, platform=lambda: "tpu")
    for sel in (port, ref):
        assert sel.current() == forced
        assert sel.maybe_reprobe() == forced
        assert sel.decisions == []
    assert port.report() == ref.report() == {"rnn_backend": forced}


def test_cpu_is_scan_without_a_probe():
    def boom():
        raise AssertionError("the CPU must not probe")

    port = BackendSelector(boom, "cpu")
    ref = JaxSelector(measure=boom, platform=lambda: "cpu")
    for sel in (port, ref):
        assert sel.current() == "scan" and sel.maybe_reprobe() == "scan"
    assert backend_select.require_kernels(port, "scan") == "scan"


def test_a_failing_probe_raises_where_jax_records_it():
    """The port's deliberate difference: the JAX selector records a probe's
    error and keeps its choice; the port's lets it reach the caller."""
    state = {"boom": False}

    def measure():
        if state["boom"]:
            raise RuntimeError("launch failed")
        return 1.0

    port = BackendSelector(measure, "cuda")
    ref = JaxSelector(measure=measure, platform=lambda: "tpu")
    assert port.current() == ref.current() == "pallas"
    state["boom"] = True
    assert ref.maybe_reprobe() == "pallas"
    assert "launch failed" in ref.decisions[-1]["error"]
    with pytest.raises(RuntimeError, match="launch failed"):
        port.maybe_reprobe()
    assert len(port.decisions) == 1


def test_a_scan_decision_on_the_card_raises(monkeypatch):
    """(v) In auto mode a probe above the limit decides ``scan``; on the
    card require_kernels turns it into an error naming the measured ms and
    the limit.  A forced scan raises too."""
    sel = BackendSelector(lambda: 25.0, "cuda")
    with pytest.raises(RuntimeError, match=r"25\.0 ms.*limit of 20\.0 ms"):
        backend_select.require_kernels(sel, sel.current())
    sel = BackendSelector(lambda: 1.0, "cuda")
    assert backend_select.require_kernels(sel, sel.current()) == "pallas"
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    with pytest.raises(RuntimeError, match="SEQ2SEQ_RNN_BACKEND=scan"):
        backend_select.require_kernels(sel, sel.current())


def test_probe_measures_on_the_cpu_without_a_kernel():
    """The probe's plain twin is x + 1, the CPU path takes it and counts
    no launch, and the measurement is a non-negative float in ms."""
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    before = probe_kernel.add_one.launches
    assert torch.equal(probe_kernel.add_one(x), x + 1.0)
    ms = probe_kernel.marginal_launch_ms(torch.device("cpu"))
    assert isinstance(ms, float) and ms >= 0.0
    assert probe_kernel.add_one.launches == before
    with pytest.raises(ValueError):
        probe_kernel.add_one(x.double())


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


def _cli(name, device, tmp_path):
    """(the CLI's main, its argv with ``-d device``)."""
    if name == "learning":
        return learning_main.main, [TOY, CSV, "-S", str(tmp_path), "-j", "r",
                                    "-d", device]
    if name == "encode":
        return (lambda argv: encode_main.main("probs", argv),
                ["ckpt.pt", TOY, CSV, "11.0", "-d", device])
    return serve_main.main, ["ckpt.pt", "11.0", "16000", "-d", device]


def _stub_models(monkeypatch):
    for module, name in ((learning_main, "Learner"),
                         (encode_main, "Encoder"),
                         (serve_main, "EncodeService")):
        monkeypatch.setattr(module, name, _stop)


@pytest.mark.parametrize("cli", ["learning", "encode", "serve"])
@pytest.mark.parametrize("variable", ["SEQ2SEQ_RNN_BACKEND",
                                      "SEQ2SEQ_ENCODER_BACKEND"])
def test_scan_is_refused_on_the_card_before_any_device(monkeypatch, tmp_path,
                                                       cli, variable):
    """(v) ``scan`` asks for the twins, which run on the CPU only: with
    -d cuda each CLI refuses it before it builds anything; with -d cpu it
    goes on (to the stubbed model)."""
    _stub_models(monkeypatch)
    monkeypatch.setenv(variable, "scan")
    main, argv = _cli(cli, "cuda", tmp_path)
    with pytest.raises(NotImplementedError, match=f"{variable}=scan"):
        main(argv)
    main, argv = _cli(cli, "cpu", tmp_path)
    with pytest.raises(_Stop):
        main(argv)


def _fake_selector(monkeypatch, latencies):
    """Every selector built from now on measures ``latencies`` in turn
    and calls itself a card's, on whatever device it is asked for."""
    def for_device(device):
        seq = iter(latencies)
        return BackendSelector(lambda: next(seq), "cuda")
    monkeypatch.setattr(backend_select, "for_device", for_device)


def _train(tmp_path, job, epochs):
    return learning_main.main(
        [TOY, CSV, "-S", str(tmp_path), "-j", job, "-e", str(epochs),
         "--pretrain_epochs", "1", "-b", "4", "-K", "4", "-f", "5",
         "--encoder_rnn_hidden_size", "5", "--decoder_rnn_hidden_size", "5",
         "--mlp_hidden_size", "5", "-N", "11.0", "-d", "cpu"])


def _log_lines(tmp_path, job, prefix):
    with open(os.path.join(str(tmp_path), job, "history.log")) as f:
        return [line.split(" - ", 2)[-1].rstrip("\n")
                for line in f if prefix in line]


def test_learner_logs_its_backend_decisions(monkeypatch, tmp_path):
    """On a card the Learner logs ``Kernel backend: {report}`` when it
    starts and ``Kernel backend decision: ...`` at each later epoch
    boundary, in the JAX package's formats (a probe inside the hysteresis
    band keeps the kernels)."""
    _fake_selector(monkeypatch, [1.0, 30.0])
    learner = _train(tmp_path, "ok", 2)
    assert learner.rnn_backend == "pallas"
    start = _log_lines(tmp_path, "ok", "Kernel backend:")
    trail = [{"context": "init", "dispatch_ms": 1.0, "backend": "pallas",
              "switched": False}]
    assert start == ["Kernel backend: " + str(
        {"rnn_backend": "pallas", "pallas_dispatch_ms": 1.0,
         "decision_trail": trail})]
    assert _log_lines(tmp_path, "ok", "Kernel backend decision:") == [
        "Kernel backend decision: pallas (dispatch 30.0 ms)"]


@pytest.mark.parametrize("latencies,where", [([25.0], "start"),
                                             ([1.0, 500.0], "epoch 2")])
def test_learner_stops_on_a_scan_decision(monkeypatch, tmp_path, latencies,
                                          where):
    """(v) A probe that decides ``scan`` stops the run, when the Learner
    starts or at an epoch boundary (after its decision line, with the
    JAX package's SWITCHED marker), instead of falling back."""
    _fake_selector(monkeypatch, latencies)
    with pytest.raises(RuntimeError, match=f"{latencies[-1]} ms"):
        _train(tmp_path, "stop", 2)
    decisions = _log_lines(tmp_path, "stop", "Kernel backend decision:")
    if where == "start":
        assert decisions == []
        assert "'rnn_backend': 'scan'" in _log_lines(
            tmp_path, "stop", "Kernel backend:")[0]
    else:
        assert decisions == ["Kernel backend decision: scan (dispatch "
                             "500.0 ms) -- SWITCHED from pallas"]
