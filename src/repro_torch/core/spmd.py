"""Wavefront superstep for chi-saturated rows: one worker thread and one
CUDA stream per shard.

Counterpart of ``repro.core.spmd``.  :mod:`repro_torch.core.distributed`'s
host pipeline issues every (row, block) of a sweep from one host thread,
and each einsumsvd reads a value back to the host (the regularized eigh's
retry check, cuSOLVER's info), so that thread waits on one card at a time
and the cards mostly take turns.  For the **chi-saturated steady state**
(interior rows whose boundary shapes are a fixed point of the absorption)
this module takes the wavefront schedule off that thread: each shard is a
persistent worker thread with its own stream on its device, and a
read-back blocks its own shard's thread alone (PyTorch releases the
interpreter lock inside its ops and inside ``.item()``).  The reference
compiles the same schedule into one ``shard_map`` program with
``ppermute`` halos; a thread per device, each with its own stream, is
PyTorch's own single-process way to drive several devices
(``torch.nn.parallel.parallel_apply``).  It keeps the superstep inside an
ordinary ``norm_squared(state, DistributedBMPS(...))`` call, and several
shards on one card (or on the CPU) run it as several streams (threads).

The superstep keeps the library's distribution contract: the identical
sequence of einsumsvd calls with identical operands and keys as the
single-device sweep and the host pipeline, so on one device type the
boundary levels are bit for bit theirs.

How a sequential zip-up becomes a wavefront
-------------------------------------------
1. **Per-column micro-steps on the existing block kernels.**
   ``zipup_block`` / ``zipup_block_twolayer`` called with a one-column
   block ARE the per-column einsumsvd steps (``first=True``: the column-0
   carry init; ``last=True`` with an empty block: the closing reshape), so
   the subscripts, operands, keys and planner signatures are those of
   every other mode (:class:`_Kernel`).

2. **Wavefront.**  With ``n`` shards of ``w`` contiguous columns and
   ``R`` saturated rows, shard ``s`` absorbs its block of row ``r`` while
   shard ``s + 1`` absorbs its block of row ``r - 1``.  Two halos per
   block edge and row, each through a one-slot channel between the two
   workers:

   * *forward*: the carry ``V`` goes ``s -> s+1`` at the end of the block;
   * *backward*: the einsumsvd at a block's first column emits the
     boundary tensor of the previous block's last column (the zip-up's
     one-column lag), which goes ``s -> s-1``; shard ``s - 1`` needs it
     before its last column of the next row, so blocks need ``w >= 2``.

   A channel carries the tensor and an event recorded after it on the
   sender's stream; the receiver's stream waits on the event before it
   reads, a tensor on another card is copied with ``.to(device,
   non_blocking=True)``, and every tensor read on a stream that did not
   allocate it is ``record_stream``-ed there.  Before a superstep the
   workers' streams wait on the caller's; before it returns, the caller's
   streams wait on every worker's.

3. **True shapes.**  Each worker runs its columns at their own shapes, the
   ramp columns at the lattice edges included, on the shard that owns
   them alone.  The reference zero-pads boundary tensors into uniform
   containers and runs the ramp columns on every shard only because one
   SPMD program needs uniform shapes.

Applicability (:func:`plan_run`, the reference's rules)
-------------------------------------------------------
A run of rows is handed to the superstep iff it is **stationary** (the
absorption maps the boundary shapes to themselves: checked by the shape
program of the micro-steps, :meth:`_Kernel.step_shape`, which applies
the einsumsvd truncation rule ``min(chi, rows, columns)``), the uniform
svd-column run ``[jl, jr)`` (``jr`` capped at ``ncol - 1``: the close is
always the last shard's) fits a split into ``n`` equal blocks
(``jl <= w - 1``, ``jr >= (n - 1) w + 1``, the largest ``n <= min(n_shards,
ncol // 2)`` dividing ``ncol``), and its rows share their site shapes.
``wavefront="spmd"`` falls back to the single-shard plan (the rows in
order on one worker) where no split exists.  The reference counts
distinct devices; the port counts **shards**, which wrap round-robin onto
the devices, so the superstep also runs on one card and on the CPU.
``wavefront="auto"`` engages only where two shards of the plan sit on
distinct devices, as the reference's does.  Bond-ramp rows and the last
row stay on the host pipeline; :func:`stats` counts both sides.

A worker that raises (``GuardExhaustedError``, a kernel's launch error)
wakes every worker blocked on a channel; the caller re-raises its
exception and stops the workers.  Nothing falls back to the host pipeline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import queue
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import counting
from repro_torch.core.engines.zipup import (_keys, zipup_block,
                                            zipup_block_twolayer)

_PLAN_CACHE: dict = {}
_FN_CACHE: dict = {}
_MISSING = object()

_STATS = {
    "plans": 0,              # plan analyses run (cache misses)
    "superstep_builds": 0,   # schedules built (cache misses)
    "superstep_calls": 0,    # supersteps run
    "rows_spmd": 0,          # rows absorbed inside the superstep
    "rows_host": 0,          # rows absorbed by the host pipeline
}                            # (rows_* tick only in "spmd"/"auto" sweeps)

# Called by a worker before each halo send as ``hook(shard, kind, tensor)``
# (``kind`` "forward" or "backward"); it returns the tensor to send.  A
# check on the card sets it to delay the sender's stream, which a receiver
# that skipped its wait would read stale memory from.
_HALO_HOOK: Optional[Callable] = None


def stats() -> dict:
    """Copy of the superstep counters (plus cache sizes)."""
    with counting.LOCK:
        out = dict(_STATS)
    out["plan_cache_size"] = len(_PLAN_CACHE)
    out["fn_cache_size"] = len(_FN_CACHE)
    return out


def reset_stats() -> None:
    with counting.LOCK:
        for k in _STATS:
            _STATS[k] = 0


def clear() -> None:
    """Drop the plan and schedule caches and the counters, and stop the
    worker threads."""
    _PLAN_CACHE.clear()
    _FN_CACHE.clear()
    reset_stats()
    _stop_workers()


def note_host_rows(n: int) -> None:
    """Record rows a "spmd"/"auto" sweep handed to the host pipeline."""
    counting.tick(_STATS, "rows_host", n)


# ---------------------------------------------------------------------------
# Per-column micro-steps, layered on the zip-up block kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Kernel:
    """One zip-up micro-step = a ``zipup_block*`` call with a 1-column block.

    ``init`` absorbs column 0 into the carry (no svd), ``step`` runs exactly
    one einsumsvd (emitting the PREVIOUS column's boundary tensor: the
    zip-up lag), ``close`` folds the final carry into the last tensor.  The
    ``*_shape`` methods are their shape program: site tensors end in
    ``(..., c, h, k)`` (left, down, right bonds), a boundary tensor in its
    right bond ``g``, a carry starts with ``nsites + 1`` row axes."""
    name: str
    nsites: int  # site operands per column: 1 one-layer, 2 two-layer

    def _block(self, v, svs, site_cols, chi, svd, keys, first, last):
        if self.nsites == 1:
            return zipup_block(v, svs, site_cols[0], chi, svd, keys,
                               first=first, last=last)
        return zipup_block_twolayer(v, svs, site_cols[0], site_cols[1],
                                    chi, svd, keys, first=first, last=last)

    def init(self, sv0, sites0, chi, svd, key):
        _, v = self._block(None, [sv0], [[t] for t in sites0], chi, svd,
                           [key], True, False)
        return v

    def step(self, v, svj, sitesj, chi, svd, key):
        out, v2 = self._block(v, [svj], [[t] for t in sitesj], chi, svd,
                              [key], False, False)
        return out[0], v2

    def close(self, v, chi, svd):
        out, _ = self._block(v, [], [[] for _ in range(self.nsites)],
                             chi, svd, [], False, True)
        return out[0]

    @staticmethod
    def _tail(sv, sites) -> Tuple[int, ...]:
        """The carry's column axes: the sites' down bonds, the boundary's
        right bond, the sites' right bonds."""
        return (tuple(s[-2] for s in sites) + (sv[-1],)
                + tuple(s[-1] for s in sites))

    def init_shape(self, sv0, sites0) -> Tuple[int, ...]:
        return ((sv0[0] * math.prod(s[-3] for s in sites0),)
                + self._tail(sv0, sites0))

    def step_shape(self, v, sv, sites, chi):
        """(emitted boundary tensor, next carry): the einsumsvd keeps
        ``min(chi, rows, columns)`` of the matricized network, as
        :class:`~repro_torch.core.einsumsvd.DirectSVD` and
        :func:`~repro_torch.core.rsvd.randomized_svd` truncate."""
        lead = tuple(v[:self.nsites + 1])
        tail = self._tail(sv, sites)
        m = min(chi, math.prod(lead), math.prod(tail))
        return lead + (m,), (m,) + tail

    def close_shape(self, v) -> Tuple[int, ...]:
        k = self.nsites + 1
        return tuple(v[:k]) + (math.prod(v[k:]),)


ONE_LAYER = _Kernel("onelayer", 1)
TWO_LAYER = _Kernel("twolayer", 2)


# ---------------------------------------------------------------------------
# Shape plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowPlan:
    """Static shape program of one saturated-row absorption.

    ``sv_shapes[c]`` / ``site_shapes[c]`` are the per-column operand
    shapes; ``sv_u`` / ``site_u`` / ``v_u`` the uniform ones.  ``[jl, jr)``
    is the uniform svd-column run; the columns outside it are the ramp and
    edge columns, confined to the first and last block.  ``n = 1`` is the
    single-shard plan: the rows in order on one worker, used by
    ``wavefront="spmd"`` when no uniform multi-shard split exists."""
    ncol: int
    n: int
    w: int
    jl: int
    jr: int
    sv_shapes: Tuple[Tuple[int, ...], ...]
    site_shapes: Tuple[Tuple[Tuple[int, ...], ...], ...]
    sv_u: Tuple[int, ...]
    site_u: Tuple[Tuple[int, ...], ...]
    v_u: Tuple[int, ...]
    dtype: str


def _eval_row(kernel: _Kernel, chi, sv_shapes, site_shapes):
    """Shape program of one row absorption.

    Returns ``(emits, vins)``: ``emits[c]`` the output boundary-tensor shape
    for slot ``c``; ``vins[c]`` the carry shape ENTERING column ``c``'s svd
    (``vins[1]`` = the init output, ``vins[ncol]`` = the close input)."""
    ncol = len(sv_shapes)
    emits: List = [None] * ncol
    vins: List = [None] * (ncol + 1)
    vins[1] = kernel.init_shape(sv_shapes[0], site_shapes[0])
    for c in range(1, ncol):
        emits[c - 1], vins[c + 1] = kernel.step_shape(
            vins[c], sv_shapes[c], site_shapes[c], chi)
    emits[ncol - 1] = kernel.close_shape(vins[ncol])
    return emits, vins


def _uniform_run(flags: Sequence[bool]) -> Tuple[int, int]:
    """Longest contiguous True run as ``[jl, jr)`` (``(0, 0)`` if none)."""
    best = (0, 0)
    start = None
    for i, f in enumerate(list(flags) + [False]):
        if f and start is None:
            start = i
        elif not f and start is not None:
            if i - start > best[1] - best[0]:
                best = (start, i)
            start = None
    return best


def _make_plan(kernel: _Kernel, chi, sv_shapes, site_shapes, dtype,
               n_shards, allow_single) -> Optional[RowPlan]:
    ncol = len(sv_shapes)
    if ncol < 2:
        return None
    emits, vins = _eval_row(kernel, chi, sv_shapes, site_shapes)
    if any(tuple(emits[c]) != tuple(sv_shapes[c]) for c in range(ncol)):
        return None  # not a shape fixed point: a bond-ramp row
    mid = ncol // 2
    sv_u, site_u, v_u = sv_shapes[mid], site_shapes[mid], vins[mid]
    flags = [False] + [
        sv_shapes[c] == sv_u and site_shapes[c] == site_u
        and vins[c] == v_u and vins[c + 1] == v_u
        and sv_shapes[c - 1] == sv_u
        for c in range(1, ncol)]
    jl, jr = _uniform_run(flags)
    # the close always runs on the last shard (it emits the final boundary
    # tensor from the carry): keep column ncol-1 out of the uniform run
    # even when its shapes happen to match the interior (e.g. bond 1)
    jr = min(jr, ncol - 1)
    layout = None
    for n in range(min(n_shards, ncol // 2), 1, -1):
        if ncol % n:
            continue
        w = ncol // n
        if jr > jl and jl <= w - 1 and jr >= (n - 1) * w + 1:
            layout = (n, w)
            break
    if layout is None:
        if not allow_single:
            return None
        layout = (1, ncol)
    return RowPlan(ncol=ncol, n=layout[0], w=layout[1], jl=jl, jr=jr,
                   sv_shapes=tuple(sv_shapes), site_shapes=tuple(site_shapes),
                   sv_u=tuple(sv_u), site_u=tuple(site_u), v_u=tuple(v_u),
                   dtype=str(dtype).replace("torch.", ""))


def _shard_devices(devices, n: int) -> Tuple[torch.device, ...]:
    """Shard ``s``'s device: ``devices[s]``, wrapping round-robin."""
    return tuple(devices[s % len(devices)] for s in range(n))


def plan_run(kernel: _Kernel, svec_cols, grids, start, chi, svd, n_shards,
             devices, mode) -> Tuple[int, Optional[RowPlan]]:
    """Longest run of rows from ``start`` the superstep can absorb.

    ``grids`` is a tuple of site grids (1 one-layer; 2 two-layer bra/ket).
    Returns ``(0, None)`` when row ``start`` is not applicable (ramp row,
    no uniform layout, or under ``"auto"`` fewer than two distinct devices
    among the plan's shards); otherwise ``(R, plan)`` where rows
    ``start..start+R-1`` share the plan's shapes."""
    nrow = len(grids[0])
    ncol = len(svec_cols)
    sv_shapes = tuple(tuple(t.shape) for t in svec_cols)

    def row_sig(i):
        return tuple(tuple(tuple(g[i][c].shape) for g in grids)
                     for c in range(ncol))

    sig0 = row_sig(start)
    allow_single = (mode == "spmd")
    key = (kernel.name, sv_shapes, sig0, str(svec_cols[0].dtype), chi, svd,
           n_shards, allow_single)
    plan = _PLAN_CACHE.get(key, _MISSING)
    if plan is _MISSING:
        counting.tick(_STATS, "plans")
        plan = _make_plan(kernel, chi, sv_shapes, sig0, svec_cols[0].dtype,
                          n_shards, allow_single)
        _PLAN_CACHE[key] = plan
    if plan is None:
        return 0, None
    if mode == "auto" and len(set(_shard_devices(devices, plan.n))) < 2:
        return 0, None
    run = 1
    while start + run < nrow and row_sig(start + run) == sig0:
        run += 1
    return run, plan


# ---------------------------------------------------------------------------
# Workers and halo channels
# ---------------------------------------------------------------------------

class _Worker:
    """A persistent daemon thread bound to one device.  On a card it owns
    a stream there; while it runs a task, that device and stream are the
    thread's current ones (as ``torch.nn.parallel.parallel_apply`` sets
    them), and the caller's grad mode is the thread's."""

    def __init__(self, name: str, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._tasks: queue.SimpleQueue = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._loop, name=name,
                                       daemon=True)
        self.thread.start()

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        self._tasks.put((fut, fn, args, torch.is_grad_enabled()))
        return fut

    def stop(self) -> None:
        self._tasks.put(None)

    def _current(self):
        stack = contextlib.ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def _loop(self) -> None:
        while True:
            task = self._tasks.get()
            if task is None:
                return
            fut, fn, args, grad = task
            try:
                with torch.set_grad_enabled(grad), self._current():
                    result = fn(self, *args)
            # the caller re-raises whatever the task raised
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
            else:
                fut.set_result(result)


_WORKERS: Dict[Tuple[int, torch.device], _Worker] = {}
_WORKERS_LOCK = threading.Lock()
# one superstep at a time: two sweeps queued on the same workers in
# opposite orders would wait on each other's halos
_SUPERSTEP_LOCK = threading.Lock()


def _workers(devices) -> List[_Worker]:
    """Shard ``s``'s persistent worker on ``devices[s]``."""
    with _WORKERS_LOCK:
        out = []
        for s, d in enumerate(devices):
            w = _WORKERS.get((s, d))
            if w is None:
                w = _WORKERS[(s, d)] = _Worker(f"repro-spmd-{s}-{d}", d)
            out.append(w)
        return out


def _stop_workers() -> None:
    with _WORKERS_LOCK:
        workers = list(_WORKERS.values())
        _WORKERS.clear()
    for w in workers:
        w.stop()
    for w in workers:
        w.thread.join()


class _Aborted(Exception):
    """Another worker of the same superstep failed."""


class _Sweep:
    """The halo channels of one superstep and the failure that wakes every
    worker waiting on one.  ``fwd[s]`` carries the carry from ``s - 1`` to
    ``s``; ``bwd[s]`` the backward emission from ``s + 1`` to ``s``."""

    def __init__(self, n: int):
        self.cond = threading.Condition()
        self.error: Optional[BaseException] = None
        self.fwd = [_Channel(self) for _ in range(n)]
        self.bwd = [_Channel(self) for _ in range(n)]

    def fail(self, error: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = error
            self.cond.notify_all()


class _Channel:
    """A one-slot hand-off of ``(tensor, event)`` between two workers."""

    def __init__(self, sweep: _Sweep):
        self.sweep = sweep
        self.full = False
        self.item = None

    def put(self, item) -> None:
        sw = self.sweep
        with sw.cond:
            while self.full and sw.error is None:
                sw.cond.wait()
            if sw.error is not None:
                raise _Aborted()
            self.item, self.full = item, True
            sw.cond.notify_all()

    def get(self):
        sw = self.sweep
        with sw.cond:
            while not self.full and sw.error is None:
                sw.cond.wait()
            if sw.error is not None:
                raise _Aborted()
            item, self.item, self.full = self.item, None, False
            sw.cond.notify_all()
            return item


def _take(t: torch.Tensor, device: torch.device, stream) -> torch.Tensor:
    """``t`` for use on the current ``stream`` of ``device`` (None on the
    CPU): copied there from another card, whose current stream in this
    thread runs the copy and so is recorded on ``t``; else recorded on
    ``stream``, which did not allocate it."""
    if t.device != device:
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
        return t.to(device, non_blocking=True)
    if stream is not None:
        t.record_stream(stream)
    return t


def _send(channel: _Channel, t: torch.Tensor, shard: int, kind: str) -> None:
    if _HALO_HOOK is not None:
        t = _HALO_HOOK(shard, kind, t)
    event = None
    if t.is_cuda:
        event = torch.cuda.Event()
        event.record()             # on the sender's current stream
    channel.put((t, event))


def _recv(channel: _Channel, worker: _Worker) -> torch.Tensor:
    t, event = channel.get()
    if event is not None:
        worker.stream.wait_event(event)
    return _take(t, worker.device, worker.stream)


# ---------------------------------------------------------------------------
# The superstep
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Job:
    """What every shard of one superstep reads (the caller's objects)."""
    schedule: "_Schedule"
    svec_cols: Sequence[torch.Tensor]
    grid_slices: Tuple
    keys_rows: Sequence[Sequence]
    sweep: _Sweep
    start_events: Tuple


def _absorb_block(worker: _Worker, job: _Job, s: int):
    """Shard ``s``'s part of the wavefront (module docstring, idea 2):
    every row of the job through its columns ``[s w, (s + 1) w)``.
    Returns ``(columns, levels, event)``: its columns of the final
    boundary, its columns of each row's level (``collect``), and an event
    after its work (on a card)."""
    try:
        return _absorb_block_rows(worker, job, s)
    except BaseException as e:
        job.sweep.fail(e)
        raise


def _absorb_block_rows(worker: _Worker, job: _Job, s: int):
    sched = job.schedule
    kernel, chi, svd = sched.kernel, sched.chi, sched.svd
    n, w = sched.plan.n, sched.plan.w
    dev, stream, sweep = worker.device, worker.stream, job.sweep
    for event in job.start_events:
        stream.wait_event(event)
    c0, last = s * w, s * w + w - 1
    sv = {c: _take(job.svec_cols[c], dev, stream) for c in range(c0, last + 1)}
    grids = job.grid_slices
    levels = [{} for _ in job.keys_rows] if sched.collect else None

    def sites(r, c):
        out = []
        for k, g in enumerate(grids):
            out.append(out[0] if k and g is grids[0]
                       else _take(g[r][c], dev, stream))
        return out

    def receive_last(r):
        # row r's emission for this block's last column, from shard s + 1
        sv[last] = _recv(sweep.bwd[s], worker)
        if levels is not None:
            levels[r][last] = sv[last]

    for r, keys in enumerate(job.keys_rows):
        if s == 0:
            v = kernel.init(sv[0], sites(r, 0), chi, svd, keys[0])
        else:
            v = _recv(sweep.fwd[s], worker)
            e, v = kernel.step(v, sv[c0], sites(r, c0), chi, svd, keys[c0])
            _send(sweep.bwd[s - 1], e, s, "backward")
        for c in range(c0 + 1, last + 1):
            if c == last and s < n - 1 and r > 0:
                receive_last(r - 1)
            e, v = kernel.step(v, sv[c], sites(r, c), chi, svd, keys[c])
            sv[c - 1] = e
            if levels is not None:
                levels[r][c - 1] = e
        if s < n - 1:
            _send(sweep.fwd[s + 1], v, s, "forward")
        else:
            sv[last] = kernel.close(v, chi, svd)
            if levels is not None:
                levels[r][last] = sv[last]
    if s < n - 1 and job.keys_rows:
        receive_last(len(job.keys_rows) - 1)
    done = None
    if stream is not None:
        done = torch.cuda.Event()
        done.record(stream)
    return sv, levels, done


@dataclasses.dataclass(frozen=True)
class _Schedule:
    """A built superstep: the plan's shards on their devices."""
    kernel: _Kernel
    chi: int
    svd: object
    plan: RowPlan
    rows: int
    collect: bool
    devices: Tuple[torch.device, ...]   # shard s -> devices[s]

    def run(self, svec_cols, grid_slices, keys_rows):
        """``(columns, levels)``: the boundary after every row, on the
        shards' devices, and (``collect``) each row's boundary by column,
        in the order the caller's streams may read them."""
        workers = _workers(self.devices)
        sweep = _Sweep(self.plan.n)
        cards = sorted({d for d in self.devices if d.type == "cuda"},
                       key=str)
        start = []
        for d in cards:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(d))
            start.append(event)
        job = _Job(self, svec_cols, grid_slices, keys_rows, sweep,
                   tuple(start))
        futures = [wk.submit(_absorb_block, job, s)
                   for s, wk in enumerate(workers)]
        try:
            for fut in futures:
                fut.exception()        # waits; a worker's error is the sweep's
        except BaseException as e:     # the caller interrupted: stop them
            sweep.fail(e)
            for fut in futures:
                fut.exception()
            raise
        if sweep.error is not None:
            _stop_workers()
            raise sweep.error
        results = [fut.result() for fut in futures]
        cols: List[Optional[torch.Tensor]] = [None] * self.plan.ncol
        levels = ([[None] * self.plan.ncol for _ in keys_rows]
                  if self.collect else None)
        for sv, lv, done in results:
            for c, t in sv.items():
                cols[c] = t
            for r, row in enumerate(lv or ()):
                for c, t in row.items():
                    levels[r][c] = t
        for wk, (_, _, done) in zip(workers, results):
            if done is not None:
                torch.cuda.current_stream(wk.device).wait_event(done)
        for t in cols + [t for row in levels or () for t in row]:
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
        return cols, levels


def _get_fn(kernel, chi, svd, plan: RowPlan, R: int, collect: bool,
            devices) -> _Schedule:
    key = (kernel.name, chi, svd, plan, R, collect, tuple(devices))
    fn = _FN_CACHE.get(key)
    if fn is None:
        counting.tick(_STATS, "superstep_builds")
        fn = _FN_CACHE[key] = _Schedule(kernel, chi, svd, plan, R, collect,
                                        tuple(devices))
    return fn


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def absorb_rows(kernel, svec_cols, grid_slices, chi, svd, plan: RowPlan,
                row_keys, devices, collect: bool = False):
    """Absorb ``len(row_keys)`` saturated rows in one superstep.

    ``grid_slices`` is a tuple of per-row site-grid slices (the SAME list
    object twice for <psi|psi>, so each site is placed once).  Shard ``s``
    of the plan runs on ``devices[s % len(devices)]``.  Returns
    ``(new_svec_cols, levels)``: the new boundary, column ``c`` on its
    shard's device, and (``collect=True``) one boundary per absorbed row,
    gathered to ``devices[0]`` as
    :func:`repro_torch.core.distributed.gather_columns` gathers."""
    R = len(row_keys)
    # each row's column keys are split once, here; the workers only read
    keys_rows = [_keys(k, plan.ncol) for k in row_keys]
    sched = _get_fn(kernel, chi, svd, plan, R, collect,
                    _shard_devices(devices, plan.n))
    with _SUPERSTEP_LOCK:
        cols, levels = sched.run(svec_cols, grid_slices, keys_rows)
    counting.tick(_STATS, "superstep_calls")
    counting.tick(_STATS, "rows_spmd", R)
    if levels is not None:
        levels = [[t.to(devices[0], non_blocking=True) for t in row]
                  for row in levels]
    return cols, levels
