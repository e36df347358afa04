"""Spans and counters: how the port times itself.

A span is a named stretch of host time on `time.perf_counter_ns`. While
torch.profiler records (`profiling()`), a span is also a profiler range of
the same name, a host operation on the profiler's timeline beside the
device's activities, so a trace names the host work under way in each idle
stretch of the device by its span. The range has the scope of a function,
not record_function's user scope: the profiler gives a user-scope range a
device-side copy over the device work launched inside it
(`gpu_user_annotation`), which a reduction of the trace would count as
device time. Otherwise a span costs two clock reads, one flag read and, in
a recorder, one append; it never waits for the device.

`Spans` records the spans and counters of one fit in memory, grouped by
epoch: the epoch index is the identifier that all spans of one epoch share.
An epoch is a flat int64 array of (name, parent row, start ns, end ns)
rows, 32 bytes a span, and a dict of counters, so the memory grows with
the number of epochs alone. Spans opened outside an epoch reach the
profiler and are not kept. `Trainer.fit` (train/loop.py) records:

    fit.epoch            the loop body of one epoch, through on_epoch_end
      fit.train          the train phase (streaming: the whole of it)
        fit.train.launch   static-buffer copies and step-graph replays
        fit.schedule       the next epoch's order, plans and sims:
          fit.schedule.plans   epoch_plans, only where the host builds
                               the plans (a node axis: not
                               Trainer.plans_on_device)
          fit.schedule.sims    epoch_compact_sims, only where the host
                               gathers the compact sims (the NP sims are
                               not on the device: Trainer.sims_on_device)
          fit.schedule.put     pinned copies to the device
        fit.train.wait     the host blocked on the train losses
      fit.eval           the validation pass (streaming: the whole of it)
        fit.eval.launch    static-buffer copies and step-graph replays
        fit.eval.wait      the host blocked on the val losses and logits
        fit.eval.metrics   per-batch accuracy and F1, AUROC
      fit.epoch_end      TensorBoard, checkpoint, log line, callbacks

and the counters `replays`, the step-graph calls of the epoch;
`device_sims`, those of them (train and eval) whose step gathered its
compact sims from the NP sims on the device (0 where the host gathers
them); and `device_plans`, the train replays whose step built its gather
plans on the device (0 where the host builds them). The counters are
absent in the streaming mode.

`last()` is the recorder of the process's last fit, for readers that see
no trainer (the benchmark's per-layer metrics).
"""
from __future__ import annotations

import time
from array import array
from typing import Dict, List, Optional

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast as _ProfilerRange

_last: Optional["Spans"] = None

# the fields of one span's row in an epoch's array
_NAME, _PARENT, _START, _END = range(4)
_WIDTH = 4


def profiling() -> bool:
    """Whether torch.profiler records on this thread (a range is entered
    only then, so that it always has the profiler's state to exit)."""
    return _profiler_enabled()


def last() -> Optional["Spans"]:
    """The recorder of the last fit in this process (None before one)."""
    return _last


class span:
    """A context manager timing one named stretch of host time: `start`
    and `end` in perf_counter nanoseconds, `seconds` between them."""

    __slots__ = ("name", "start", "end", "_range")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = 0
        self._range = None

    def __enter__(self) -> "span":
        if profiling():
            self._range = _ProfilerRange(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class _Kept(span):
    """A span that its recorder keeps in the open epoch."""

    __slots__ = ("rec", "row")

    def __init__(self, rec: "Spans", name: str):
        super().__init__(name)
        self.rec, self.row = rec, -1

    def __enter__(self) -> "_Kept":
        super().__enter__()
        rec = self.rec
        if rec._rows is not None:
            self.row = len(rec._rows) // _WIDTH
            rec._rows.extend((rec._id(self.name),
                              rec._open[-1] if rec._open else -1,
                              self.start, 0))
            rec._open.append(self.row)
        return self

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        rec = self.rec
        if self.row >= 0 and rec._rows is not None:
            rec._rows[self.row * _WIDTH + _END] = self.end
            rec._open.pop()


class _Epoch(_Kept):
    """The span of a whole epoch: closing it closes the epoch."""

    __slots__ = ()

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        self.rec._rows = self.rec._counts = None


class Spans:
    """The spans and counters of one fit, by epoch (module docstring)."""

    def __init__(self):
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}
        self.epochs: Dict[int, array] = {}
        self.counters: Dict[int, Dict[str, int]] = {}
        self._rows: Optional[array] = None     # the open epoch's rows
        self._counts: Optional[Dict[str, int]] = None
        self._open: List[int] = []             # rows of the open spans

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i

    def epoch(self, index: int) -> span:
        """Open epoch `index` (its records start empty); returns its
        `fit.epoch` span, whose end closes it."""
        self._rows = self.epochs[index] = array("q")
        self._counts = self.counters[index] = {}
        self._open = []
        return _Epoch(self, "fit.epoch")

    def span(self, name: str) -> span:
        """A span kept in the open epoch, inside the innermost open one."""
        return _Kept(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the open epoch's counter `name`."""
        if self._counts is not None:
            self._counts[name] = self._counts.get(name, 0) + n

    # ------------------------------------------------------------ reading

    def rows(self, epoch: int) -> List[tuple]:
        """(name, parent row, start ns, end ns) of each span of `epoch`,
        in the order they opened; row 0 is `fit.epoch`."""
        a = self.epochs[epoch]
        return [(self.names[a[i + _NAME]], a[i + _PARENT], a[i + _START],
                 a[i + _END]) for i in range(0, len(a), _WIDTH)]

    def total_ns(self, epoch: int, name: str) -> Optional[int]:
        """Nanoseconds of the spans named `name` in `epoch`, summed; None
        where the epoch has none."""
        i = self._ids.get(name)
        a = self.epochs[epoch]
        durations = [a[r + _END] - a[r + _START]
                     for r in range(0, len(a), _WIDTH) if a[r + _NAME] == i]
        return sum(durations) if durations else None

    def unspanned_ns(self, epoch: int) -> int:
        """Nanoseconds of `epoch`'s `fit.epoch` that no innermost span
        covers: the self time of it and of every span with children."""
        rows = self.rows(epoch)
        parents = {p for _, p, _, _ in rows}
        leaves = sum(e - s for i, (_, _, s, e) in enumerate(rows)
                     if i not in parents)
        return rows[0][3] - rows[0][2] - leaves


def begin_fit() -> Spans:
    """A new recorder for a fit, which `last()` then returns."""
    global _last
    _last = Spans()
    return _last
