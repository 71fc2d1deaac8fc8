"""The kernel-backend selector (the port of
seq2seq_abcd_vae_tpu/utils/backend_select.py): a measured launch cost,
re-measured with hysteresis, and a trail of every decision.

As in the JAX package:

- at first use in auto mode, one probe (``ops/probe_kernel.
  marginal_launch_ms``: the median of up to 3 pipelined samples of the
  marginal cost of a hand-written launch) picks ``pallas`` iff it is under
  ``SEQ2SEQ_PALLAS_DISPATCH_MS_MAX`` (default 20 ms);
- ``maybe_reprobe`` measures again; leaving ``pallas`` takes a cost above
  2x the limit, coming back one below 0.5x, and a cost inside the band
  keeps the choice;
- each probe appends ``{context, dispatch_ms, backend, switched}`` to
  ``decisions``; ``report()`` gives ``{"rnn_backend", "pallas_dispatch_ms",
  "decision_trail"}``, which the Learner logs to history.log;
- ``SEQ2SEQ_RNN_BACKEND=scan|pallas`` forces the choice (no probe, no
  switch); on the CPU the answer is ``scan`` without a probe.

The names are the JAX package's: ``pallas`` is the port's hand-written
kernels, ``scan`` its plain PyTorch twins.  Where the port differs:

- **Owned, not global.**  Each ``Learner``, ``Encoder`` and
  ``EncodeService`` (through its ``Encoder``) owns one selector; there is
  no module-level instance.
- **``measure`` and ``platform`` are arguments.**  ``platform`` is the
  device type (``cuda`` or ``cpu``); ``measure`` returns the cost in ms.
- **Errors propagate.**  The JAX selector records a failed probe and keeps
  its choice; here the probe's error reaches the caller.
- **No scan path on the card.**  The twins run on CPU tensors only, so on
  the card :func:`require_kernels` turns any ``scan`` (forced, or decided
  by a probe) into an error that names the measured cost and the limit;
  the training, encode and serve CLIs refuse ``SEQ2SEQ_RNN_BACKEND=scan``
  and ``SEQ2SEQ_ENCODER_BACKEND=scan`` on the card before they touch it
  (``cli/flags.refuse_unported``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ..ops.probe_kernel import dispatch_limit_ms, marginal_launch_ms

# hysteresis band: leave pallas above limit * _UP_FACTOR, come back below
# limit * _DOWN_FACTOR; anything between keeps the current choice
_UP_FACTOR = 2.0
_DOWN_FACTOR = 0.5


class BackendSelector:
    """Measured scan-or-kernels choice with re-probe hysteresis."""

    def __init__(self, measure: Callable[[], float], platform: str):
        self._measure = measure
        self.platform = platform
        self._current: Optional[str] = None
        self.decisions: list[dict] = []

    def current(self) -> str:
        """The backend in effect (probing on first use in auto mode)."""
        forced = self._forced()
        if forced is not None:
            return forced
        if self._current is None:
            self.maybe_reprobe(context="init")
        return self._current

    def maybe_reprobe(self, context: str = "epoch") -> str:
        """Measure the launch cost again and apply the hysteresis; returns
        the (possibly new) backend.  No probe in a forced mode or on the
        CPU."""
        forced = self._forced()
        if forced is not None:
            self._current = forced
            return forced
        if self.platform == "cpu":
            self._current = "scan"
            return "scan"
        limit = dispatch_limit_ms()
        ms = self._measure()
        if self._current is None:
            choice = "pallas" if ms < limit else "scan"
        elif self._current == "pallas":
            choice = "scan" if ms > limit * _UP_FACTOR else "pallas"
        else:
            choice = "pallas" if ms < limit * _DOWN_FACTOR else "scan"
        self._record(context, ms, choice)
        return choice

    def report(self) -> dict:
        out = {"rnn_backend": self.current()}
        if self.decisions:
            out["pallas_dispatch_ms"] = self.decisions[-1]["dispatch_ms"]
            out["decision_trail"] = list(self.decisions)
        return out

    @staticmethod
    def _forced() -> Optional[str]:
        mode = os.environ.get("SEQ2SEQ_RNN_BACKEND", "auto")
        return mode if mode in ("scan", "pallas") else None

    def _record(self, context: str, ms: float, choice: str) -> None:
        self.decisions.append({
            "context": context,
            "dispatch_ms": round(ms, 3),
            "backend": choice,
            "switched": self._current is not None and choice != self._current,
        })
        self._current = choice


def for_device(device) -> BackendSelector:
    """A selector for ``device`` (a ``torch.device``) measuring with the
    launch-cost probe on it."""
    return BackendSelector(lambda: marginal_launch_ms(device), device.type)


def require_kernels(selector: BackendSelector, choice: str) -> str:
    """``choice`` if the port can run it on the selector's platform: on the
    card only the kernels (``pallas``) run, so ``scan`` raises
    RuntimeError with the measured cost and the limit."""
    if choice == "scan" and selector.platform != "cpu":
        if BackendSelector._forced() == "scan" or not selector.decisions:
            raise RuntimeError(
                "SEQ2SEQ_RNN_BACKEND=scan asks for the plain PyTorch twins, "
                "which run on the CPU only; the card runs the kernels")
        ms = selector.decisions[-1]["dispatch_ms"]
        raise RuntimeError(
            f"the launch-cost probe measured {ms} ms per kernel launch, "
            f"above the limit of {dispatch_limit_ms()} ms "
            "(SEQ2SEQ_PALLAS_DISPATCH_MS_MAX), so the selector chose "
            "'scan'; the port has no scan path on the card")
    return choice
