"""The port's tracing: spans and counters of a frame, and the hand-written
kernels' launch counts.

Off by default: `span` then returns one shared object that does nothing
and `count` returns at once. After `enable()` a span adds its host
seconds (`time.perf_counter`) to the current record under its name and,
while a `torch.profiler` records, opens a `record_function` range of the
same name, so that the profiler's trace holds the span on the clock of
the device's kernels; `count` adds to a counter of the record. `take()`
hands the record over and starts the next one: a caller takes it once a
frame.

Every name starts with `gsdf.`, and none holds a kernel's name as a word
(tools find kernels in a trace by words of their names):

    gsdf.track.launch    track_frame until the loop kernel is enqueued
                         (the CPU path: the compaction)
    gsdf.track.read      track_frame's status read (the CPU path: the
                         plain GN loop)
    gsdf.fuse.launch     GradSdfMap.update until fusion is enqueued
    gsdf.fuse.read       update's growth-flag read
    gsdf.fuse.grow       the grid's growth, on the frames that need it
    gsdf.frame.upload, gsdf.frame.pose_read
                         apps/scan3d's upload of a frame and pose read
    gsdf.reads           (counter) the explicit device-to-host reads of
                         the frame's path
    gsdf.fuse.graph_captures
                         (counter) `update`'s captures of a fused frame
                         as a CUDA graph (`models/grad_sdf`)
    gsdf.fuse.graph_replays
                         (counter) fused frames that `update` served by a
                         replay of that graph

A replay runs the launches its capture made: `add_launches` counts them
on the wrappers' counters, so `launches()` counts the kernels that ran.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import NamedTuple

import torch


class Record(NamedTuple):
    spans: dict      # name -> host seconds
    counters: dict   # name -> count


# (name, module under ops/kernels, its counter): every hand-written
# wrapper's launches since its module's reset_launch_count()
_LAUNCH_COUNTERS = (
    ("scatter_add", "scatter_add", "launch_count"),
    ("scatter_add_rows", "scatter_add", "rows_launch_count"),
    ("merge_clear", "merge_clear", "launch_count"),
    ("raycast_march", "raycast_march", "launch_count"),
    ("gn_residual_reduce", "gn_track", "launch_count"),
    ("gn_step", "gn_track", "step_launch_count"),
    ("gn_track_loop", "gn_track", "loop_launch_count"),
    ("fuse_claim", "fuse_integrate", "claim_launch_count"),
    ("fuse_integrate", "fuse_integrate", "launch_count"),
    ("fals_normals", "fals_normals", "launch_count"),
    ("track_compact", "track_compact", "launch_count"),
    ("ba_voxel_sums", "ba_terms", "launch_count"),
    ("ba_pose_systems", "ba_terms", "pose_launch_count"),
    ("render_windows", "render_windows", "launch_count"),
    ("prior_windows", "prior_windows", "launch_count"),
    ("ray_finish", "ray_finish", "launch_count"),
)

_on = False
_record = Record({}, {})
_counters = None   # _LAUNCH_COUNTERS with the modules imported


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.range = (torch.profiler.record_function(self.name)
                      if torch.autograd._profiler_enabled() else None)
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        spans = _record.spans
        spans[self.name] = spans.get(self.name, 0.0) + dt
        return False


def enable():
    """Tracing on for the process, from an empty record."""
    global _on
    _on = True
    take()


def disable():
    """Tracing off; the record is dropped."""
    global _on
    _on = False
    take()


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def tracing(on: bool = True):
    """Tracing on inside the block where `on`, and back as it was after."""
    was = _on
    if on and not was:
        enable()
    try:
        yield
    finally:
        if on and not was:
            disable()


def span(name: str):
    """A context manager that times its block under `name` (module note)."""
    return _Span(name) if _on else _OFF


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` of the current record."""
    if _on:
        c = _record.counters
        c[name] = c.get(name, 0) + n


def take() -> Record:
    """The record since the last take (empty while tracing is off), and a
    new one begun."""
    global _record
    rec, _record = _record, Record({}, {})
    return rec


def _launch_counters():
    global _counters
    if _counters is None:
        _counters = [(name, importlib.import_module(f"..ops.kernels.{mod}",
                                                    __package__), attr)
                     for name, mod, attr in _LAUNCH_COUNTERS]
    return _counters


def launches() -> dict:
    """{name: launches} of every hand-written kernel wrapper, one snapshot
    of their modules' counters. `scatter_add` counts the F = 1 launches
    that `scatter_add_rows` counts again."""
    return {name: getattr(mod, attr) for name, mod, attr in _launch_counters()}


def launched(since: dict) -> int:
    """Kernel launches since the snapshot `since` (`launches()`), each once."""
    now = launches()
    return sum(now[k] - since[k] for k in now if k != "scatter_add_rows")


def add_launches(counts: dict):
    """Add `counts` ({name: launches}, names as in `launches()`) to the
    wrappers' counters."""
    for name, mod, attr in _launch_counters():
        if name in counts:
            setattr(mod, attr, getattr(mod, attr) + counts[name])


def reset_launches():
    """Every kernel module's `reset_launch_count()`."""
    for mod in {mod for _, mod, _ in _launch_counters()}:
        mod.reset_launch_count()
