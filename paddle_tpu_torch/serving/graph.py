"""The serving step captured once into a CUDA graph and replayed on every
step: the port's counterpart of the reference's compile-once step
(``paddle_tpu/serving/engine.py`` ``warmup``: the ragged step compiles
once and serving traffic compiles nothing after it) and of its recompile
accounting.

:class:`StepGraph` owns the step's static inputs (int32 device buffers of
fixed shape) and its static output.  Each step copies the scheduler's
numpy arrays into the inputs (through pinned host staging, without
blocking the host, on the card) and then replays the graph, which reads
them.  Before the capture, one eager call on a side stream builds and
loads every kernel library and launches every kernel variant that the
shape-only plans pick: a module cannot be loaded inside a capture (CUDA
12 loads them lazily, at first launch).

A replay runs the captured kernels without Python, so no wrapper counts
its launch.  The capture records each kernel's launch count
(:func:`launch_delta`) and takes it back, since a capture enqueues
nothing that runs; every replay credits it again (:func:`credit_launches`),
so ``ops.cuda.counts("cuda")`` keeps counting the launches that ran.

The wrappers' per-call scratch (``torch.empty``) comes from the graph's
private memory pool at capture and is reused by every replay: safe while
one stream at a time replays the graph, as the engine's step does.

On the CPU (and on the card for an engine built eager) the same function
runs eagerly on the same static buffers.  A capture or replay error
raises: nothing falls back to the eager step.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops import cuda as _kernels

__all__ = ["StepGraph", "credit_launches", "launch_delta"]


def launch_delta(before: Mapping[str, int],
                 after: Mapping[str, int]) -> Dict[str, int]:
    """Each kernel's launches between two ``ops.cuda.counts`` readings."""
    return {name: after[name] - before[name] for name in after}


def credit_launches(kernels: Mapping[str, object],
                    delta: Mapping[str, int]) -> None:
    """Add ``delta[name]`` to ``kernels[name].launches``: what one replay
    of a graph launched, by kernel."""
    for name, n in delta.items():
        if n:
            kernels[name].launches += n


class StepGraph:
    """``fn(**inputs)`` on static int32 input buffers of the given
    ``shapes``, captured once into a CUDA graph when ``capture`` (the
    card) and run eagerly otherwise.

    ``captures`` is 1 once :meth:`prepare` captured the graph, and stays
    there; ``replays`` counts the replays; ``launches`` is one replay's
    launches by kernel.  ``replay_events``, when set to a list, collects a
    (start, end) CUDA event pair around each replay, the graph's device
    time."""

    def __init__(self, fn: Callable[..., torch.Tensor],
                 shapes: Mapping[str, tuple], device: torch.device,
                 capture: bool):
        self.fn = fn
        self.device = device
        self.capture = bool(capture)
        self.inputs = {name: torch.zeros(shape, dtype=torch.int32,
                                         device=device)
                       for name, shape in shapes.items()}
        self.output: Optional[torch.Tensor] = None
        self.captures = 0
        self.replays = 0
        self.launches: Optional[Dict[str, int]] = None
        self.replay_events: Optional[list] = None
        self.ready = False
        self._graph = None
        self._staging = None
        self._staged = None
        if device.type == "cuda":
            self._staging = {name: torch.zeros(shape, dtype=torch.int32,
                                               pin_memory=True)
                             for name, shape in shapes.items()}

    def load(self, arrays: Mapping[str, np.ndarray]) -> None:
        """Copy one step's inputs into the static buffers, in stream order
        before the next run."""
        if self._staging is None:
            for name, a in arrays.items():
                self.inputs[name].copy_(torch.from_numpy(a))
            return
        if self._staged is not None:
            # the last step's copies may still read the staging buffers
            self._staged.synchronize()
        for name, a in arrays.items():
            self._staging[name].numpy()[...] = a
            self.inputs[name].copy_(self._staging[name], non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()

    def prepare(self) -> None:
        """Run the step once, eagerly, on the current inputs and, when
        capturing, capture it.  Only the first call does anything."""
        if self.ready:
            return
        if self.capture:
            self._capture()
        else:
            self._eager()
        self.ready = True

    def _eager(self) -> torch.Tensor:
        out = self.fn(**self.inputs)
        if self.output is None:
            self.output = out
        else:
            self.output.copy_(out)
        return self.output

    def _capture(self) -> None:
        dev = self.device
        here = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            self.fn(**self.inputs)
        here.wait_stream(side)
        torch.cuda.synchronize(dev)
        before = _kernels.counts("cuda")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(**self.inputs)
        delta = launch_delta(before, _kernels.counts("cuda"))
        credit_launches(_kernels.KERNELS, {k: -n for k, n in delta.items()})
        self._graph, self.output, self.launches = graph, out, delta
        self.captures += 1

    def run(self, eager: bool = False) -> torch.Tensor:
        """One step on the loaded inputs; returns the static output.
        ``eager`` runs the function on the same buffers without the graph
        (an in-process eager twin of the captured step)."""
        if eager or not self.capture:
            return self._eager()
        if self._graph is None:
            raise RuntimeError("StepGraph.run() before prepare(): the step "
                               "is captured once, at warmup")
        if self.replay_events is None:
            self._graph.replay()
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self._graph.replay()
            end.record()
            self.replay_events.append((start, end))
        self.replays += 1
        credit_launches(_kernels.KERNELS, self.launches)
        return self.output
