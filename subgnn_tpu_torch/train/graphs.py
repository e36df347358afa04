"""A step captured once as a CUDA graph and replayed once per call.

The fused trainer (train/loop.py) and the bench run their training step
this way: the counterpart of the JAX package's one XLA dispatch per epoch
(subgnn_tpu/train/loop.py:198-264, bench.py:129-136) is a step whose work
the host enqueues with one `CUDAGraph.replay()` instead of hundreds of
kernel launches from Python.

A step is a function of no arguments that reads and writes tensors at fixed
addresses only: its inputs are copied into static buffers before a call,
and its results (parameters, optimizer and model state, the loss) are
written in place. `StepGraph` runs it:
  * call 1 runs it eagerly on a side stream: a real step, which also makes
    the lazy state that capture cannot create (cuBLAS workspaces, the
    table-gradient kernel's ticket words for that stream);
  * call 2 captures it on that stream, then replays the graph;
  * every later call replays the graph.
On the CPU every call runs the step eagerly, through the same sequence
(`captures` counts where the card would capture), so the CPU tests drive
the fused trainer's control flow. A failed capture or replay raises.

Capture launches no kernel and runs no collective, yet the kernel wrappers
and the mesh's collective helpers (parallel/mesh.py) called while capturing
add to their counts (`launches`; `calls` and `bytes`). So the counts are
put back after capture, and each replay adds what it holds: a count still
reads one per launch, or per collective, on the card.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops import embedding
from ..parallel import mesh

# (object, attribute) of each count a training step may add to: the kernel
# wrappers' launches, the collectives' calls and bytes
COUNTED = ((embedding.segment_matmul, "launches"),
           *((helper, attr) for helper in mesh.COLLECTIVES
             for attr in ("calls", "bytes")))


class StepGraph:
    """Run `fn` once per call (see the module docstring). `generators`:
    the torch.Generators `fn` draws from, registered with the graph so
    that each replay draws fresh numbers and advances them as an eager
    call would."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.calls = 0
        self.captures = 0
        self.graph = None
        self.per_replay = [0] * len(COUNTED)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self) -> None:
        self.calls += 1
        if self.calls == 2:
            self.captures += 1
        if self.stream is None:
            self.fn()
        elif self.calls == 1:
            self._eager_on_side_stream()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for (obj, attr), n in zip(COUNTED, self.per_replay):
                setattr(obj, attr, getattr(obj, attr) + n)

    def _eager_on_side_stream(self) -> None:
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            self.fn()
        main.wait_stream(self.stream)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = [getattr(obj, attr) for obj, attr in COUNTED]
        with torch.cuda.graph(graph, stream=self.stream):
            self.fn()
        self.per_replay = [getattr(obj, attr) - b
                           for (obj, attr), b in zip(COUNTED, before)]
        for (obj, attr), b in zip(COUNTED, before):
            setattr(obj, attr, b)
        self.graph = graph
