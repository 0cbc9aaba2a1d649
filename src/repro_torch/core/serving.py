"""Batched PEPS query serving: amplitudes and observables as a service.

Counterpart of ``repro.core.serving``.  Many ``<x|psi>`` and
``<psi|O|psi>`` queries against a few hot PEPS states (the RQC amplitude
workload of paper Section VI), where most of each boundary sweep is
shared between queries:

* **Environment prefix cache** — per registered state, an LRU cache of
  one-layer boundary environments keyed by the query's bit prefix (the
  bits of rows ``0..nrow-2``).  Queries sharing a prefix share the sweep;
  the final row's down bonds are dim 1, so the rest is one exact batched
  close (:func:`repro_torch.core.bmps.final_row_amplitudes`).  Observable
  queries use the query-independent
  :func:`repro_torch.core.environments.row_environments`: two sweeps per
  state, then one strip contraction per term.
* **Bucketed batches** — amplitude requests of one state and prefix are
  closed together, in chunks padded up to a fixed ladder of sizes.  The
  close itself runs at one width (``bmps.CLOSE_WIDTH``), so a value does
  not depend on the queries it was batched with.
* **Request queue + dispatcher** — ``submit_*`` returns a
  :class:`concurrent.futures.Future`; one dispatcher thread drains the
  queue for up to ``window_ms`` (or ``max_batch`` requests), groups by
  state and executes.  All tensor work runs under one engine lock, in the
  dispatcher thread or in the caller's thread for the synchronous entry
  points, so arrival order never changes a value.

Cache lifecycle:

* ``register_state`` with an existing name invalidates that state's cached
  environments: a query that starts after it returns sees the new tensors.
* At most ``max_states`` states keep materialized caches; the least
  recently queried one's environments are dropped.  The state stays
  registered, and its next query rebuilds them.
* Eviction only unlinks cache entries: an in-flight batch holds references
  to the environments it reads.

Results are tensors on the state's device.
"""
from __future__ import annotations

import collections
import dataclasses
import queue as _queuelib
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bmps import BMPS, final_row_amplitudes
from repro_torch.core.engines import get_engine
from repro_torch.core.engines.zipup import _keys
from repro_torch.core.environments import onelayer_prefix_environment, \
    row_environments
from repro_torch.core.expectation import DEFAULT_EXPECTATION_KEY_SEED, \
    expectation_from_envs
from repro_torch.core.keys import key_or_default
from repro_torch.core.observable import Observable

#: Default ladder of amplitude batch sizes: a group of B queries runs in
#: full chunks of the largest bucket, then the smallest bucket that fits
#: the remainder (padded).
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class LRUCache:
    """Ordered-dict LRU with hit/miss/eviction counters.

    Not locked: the serving engine serializes all access.  ``get`` counts a
    hit or a miss; ``peek`` counts neither (ancestor-prefix probes), so the
    counters reconcile as one lookup per query group."""

    def __init__(self, max_entries: int):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self):
        return len(self._d)

    def get(self, key):
        try:
            val = self._d[key]
        except KeyError:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return val

    def peek(self, key):
        val = self._d.get(key)
        if val is not None:
            self._d.move_to_end(key)
        return val

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.evictions += 1

    def clear(self):
        self._d.clear()

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._d)}


@dataclasses.dataclass
class _StateEntry:
    """A registered state plus its derived, evictable caches."""
    name: str
    state: object
    option: BMPS
    amp_keys: list                 # per-row keys, as in contract_onelayer
    env_key: object                # row_environments key (observables)
    prefix: LRUCache               # bit-prefix tuple -> boundary MPS
    version: int
    obs_envs: Optional[tuple] = None   # cached (top, bottom) or None
    obs_env_builds: int = 0
    obs_env_hits: int = 0


@dataclasses.dataclass
class _Request:
    kind: str                      # "amplitude" | "expectation"
    name: str
    payload: object                # (nrow, ncol) int bits / Observable
    future: Future
    submitted: float


_SHUTDOWN = object()


def _resolve(future: Future, value=None, error: Exception = None) -> None:
    if future.cancelled():
        return
    if error is not None:
        future.set_exception(error)
    else:
        future.set_result(value)


class ServingEngine:
    """Batched PEPS query engine with an environment prefix cache.

    max_states:    registered states that keep materialized caches (LRU on
                   the last query).
    max_prefixes:  per-state bound on cached bit-prefix environments.
    bucket_sizes:  amplitude batch-size ladder.
    window_ms:     micro-batching window: after the first request is
                   dequeued, keep draining for this long (or until
                   ``max_batch``) before executing.
    max_batch:     upper bound on requests per dispatch cycle.
    start:         start the dispatcher thread now.  Without it the
                   synchronous entry points still work; ``submit_*``
                   starts it lazily.

    The synchronous entry points and the dispatcher share one compute path
    and one lock, so a value never depends on which path served it."""

    def __init__(self, max_states: int = 4, max_prefixes: int = 128,
                 bucket_sizes: Sequence[int] = DEFAULT_BUCKETS,
                 window_ms: float = 2.0, max_batch: int = 256,
                 start: bool = True):
        if max_states < 1:
            raise ValueError("max_states must be >= 1")
        self.max_states = max_states
        self.max_prefixes = max_prefixes
        self.bucket_sizes = tuple(sorted(set(int(b) for b in bucket_sizes)))
        if not self.bucket_sizes or self.bucket_sizes[0] < 1:
            raise ValueError("bucket_sizes must be positive")
        self.window_ms = float(window_ms)
        self.max_batch = int(max_batch)
        self._states: Dict[str, _StateEntry] = {}
        self._hot: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.RLock()
        self._queue: "_queuelib.Queue" = _queuelib.Queue()
        self._counters = collections.Counter()
        self._dispatcher: Optional[threading.Thread] = None
        self._closed = False
        if start:
            self._ensure_dispatcher()

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Stop the dispatcher (idempotent); pending requests drain first."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t = self._dispatcher
        if t is not None:
            self._queue.put(_SHUTDOWN)
            t.join()
        with self._lock:
            self._dispatcher = None

    def _ensure_dispatcher(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            if self._dispatcher is None or not self._dispatcher.is_alive():
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, name="peps-serving-dispatch",
                    daemon=True)
                self._dispatcher.start()

    # -- registration -------------------------------------------------------

    def register_state(self, name: str, state, option: BMPS, key=None,
                       env_key=None) -> None:
        """Register (or replace) a servable state.

        ``option`` must be a single-device
        :class:`~repro_torch.core.bmps.BMPS`.  ``key``
        seeds the amplitude row keys as ``bmps.amplitude(..., key=key)``
        does; ``env_key`` seeds the observable row environments (default:
        the key of :func:`repro_torch.core.expectation.expectation`).
        Re-registering a name replaces the state and invalidates every
        cached environment derived from it."""
        if not isinstance(option, BMPS):
            raise TypeError(
                f"serving requires a single-device BMPS option, got "
                f"{type(option).__name__}")
        get_engine(option.engine)  # fail fast
        env_key = key_or_default(env_key, DEFAULT_EXPECTATION_KEY_SEED)
        amp_keys = list(_keys(key, max(state.nrow, 2)))
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            old = self._states.get(name)
            self._states[name] = _StateEntry(
                name=name, state=state, option=option, amp_keys=amp_keys,
                env_key=env_key, prefix=LRUCache(self.max_prefixes),
                version=old.version + 1 if old is not None else 0)
            # the new entry starts cold and holds no budget slot
            self._hot.pop(name, None)
            if old is not None:
                self._counters["invalidations"] += 1

    def unregister(self, name: str) -> None:
        with self._lock:
            self._states.pop(name)  # KeyError propagates: caller bug
            self._hot.pop(name, None)

    def registered(self) -> List[str]:
        with self._lock:
            return list(self._states)

    # -- submission (thread-safe; any thread) -------------------------------

    def submit_amplitude(self, name: str, bits) -> Future:
        """Enqueue one <bits|psi> query; resolves to a complex scalar."""
        self._ensure_dispatcher()
        fut: Future = Future()
        self._queue.put(_Request("amplitude", name,
                                 np.asarray(bits, dtype=np.int64), fut,
                                 time.monotonic()))
        return fut

    def submit_expectation(self, name: str, obs: Observable) -> Future:
        """Enqueue one <psi|O|psi>/<psi|psi> query."""
        self._ensure_dispatcher()
        fut: Future = Future()
        self._queue.put(_Request("expectation", name, obs, fut,
                                 time.monotonic()))
        return fut

    # -- synchronous entry points ------------------------------------------

    def amplitude(self, name: str, bits) -> torch.Tensor:
        return self.amplitude_batch(name, [bits])[0]

    def amplitude_batch(self, name: str, bits_batch) -> torch.Tensor:
        """Serve an amplitude batch in the calling thread (same cache,
        buckets and closes as the queued path, without its latency)."""
        with self._lock:
            entry = self._entry(name)
            bits_arr = self._check_bits(entry, np.asarray(bits_batch,
                                                          dtype=np.int64))
            return self._execute_amplitudes(entry, bits_arr)

    def expectation(self, name: str, obs: Observable) -> torch.Tensor:
        with self._lock:
            return self._execute_expectation(self._entry(name), obs)

    # -- stats --------------------------------------------------------------

    def stats(self) -> Dict:
        """Counters + per-state cache stats (a consistent snapshot)."""
        with self._lock:
            out = dict(self._counters)
            for k in ("queries_amplitude", "queries_expectation", "batches",
                      "rows_absorbed", "state_evictions", "invalidations",
                      "padded_queries"):
                out.setdefault(k, 0)
            per_state = {}
            for name, entry in self._states.items():
                st = {f"prefix_{k}": v for k, v in entry.prefix.stats().items()}
                st["obs_env_builds"] = entry.obs_env_builds
                st["obs_env_hits"] = entry.obs_env_hits
                st["version"] = entry.version
                st["materialized"] = name in self._hot
                per_state[name] = st
            out["per_state"] = per_state
            out["states"] = len(self._states)
            return out

    # -- internals ----------------------------------------------------------

    def _entry(self, name: str) -> _StateEntry:
        try:
            return self._states[name]
        except KeyError:
            raise KeyError(
                f"state {name!r} is not registered (have "
                f"{sorted(self._states)})") from None

    @staticmethod
    def _check_single(entry: _StateEntry, bits_arr: np.ndarray) -> np.ndarray:
        """One query's bits -> (nrow, ncol); flat or grid layout."""
        nrow, ncol = entry.state.nrow, entry.state.ncol
        if bits_arr.size != nrow * ncol:
            raise ValueError(
                f"bits shape {bits_arr.shape} does not match the "
                f"{nrow}x{ncol} grid of {entry.name!r}")
        return bits_arr.reshape(nrow, ncol)

    @staticmethod
    def _check_bits(entry: _StateEntry, bits_arr: np.ndarray) -> np.ndarray:
        """A batch of queries -> (B, nrow, ncol).  Accepts
        ``(B, nrow, ncol)``, ``(B, nrow*ncol)`` or one query; a 2-D array
        of one grid's size is always one query."""
        nrow, ncol = entry.state.nrow, entry.state.ncol
        if bits_arr.ndim == 1 or bits_arr.size == nrow * ncol:
            return ServingEngine._check_single(entry, bits_arr)[None]
        B = bits_arr.shape[0]
        if bits_arr.size != B * nrow * ncol:
            raise ValueError(
                f"bits batch shape {bits_arr.shape} does not match the "
                f"{nrow}x{ncol} grid of {entry.name!r}")
        return bits_arr.reshape(B, nrow, ncol)

    def _touch(self, entry: _StateEntry) -> None:
        """Mark a state's caches materialized and recently used; drop the
        least recently queried other state's caches beyond ``max_states``."""
        self._hot[entry.name] = True
        self._hot.move_to_end(entry.name)
        while len(self._hot) > self.max_states:
            victim = self._states.get(self._hot.popitem(last=False)[0])
            if victim is not None:
                victim.prefix.clear()
                victim.obs_envs = None
                self._counters["state_evictions"] += 1

    def _prefix_env(self, entry: _StateEntry, prefix: tuple):
        """Boundary MPS of a bit prefix, through the LRU cache: one counted
        lookup at full depth; on a miss, uncounted probes find the deepest
        cached ancestor, and only the missing rows are absorbed (every
        level is cached)."""
        state, option = entry.state, entry.option
        if len(prefix) == 0:  # one-row state: trivial boundary above row 0
            return onelayer_prefix_environment(state, prefix, option)
        env = entry.prefix.get(prefix)
        if env is not None:
            return env
        depth = len(prefix)
        k = depth - 1
        while k >= 1:
            env = entry.prefix.peek(prefix[:k])
            if env is not None:
                break
            k -= 1
        if env is None:
            k = 1
            row0 = [state.sites[0][j][int(b)] for j, b in enumerate(prefix[0])]
            env = [t.reshape(t.shape[1], t.shape[2], t.shape[3]) for t in row0]
            entry.prefix.put(prefix[:1], env)
        eng = get_engine(option.engine)
        while k < depth:
            row = [state.sites[k][j][int(b)] for j, b in enumerate(prefix[k])]
            env = eng.absorb_onelayer(env, row, option.chi, option.svd,
                                      entry.amp_keys[k])
            k += 1
            entry.prefix.put(prefix[:k], env)
            self._counters["rows_absorbed"] += 1
        return env

    def _chunks(self, n: int) -> List[int]:
        """Split a group of n queries into padded bucket-sized chunks."""
        out = []
        big = self.bucket_sizes[-1]
        while n >= big:
            out.append(big)
            n -= big
        if n > 0:
            out.append(next(b for b in self.bucket_sizes if b >= n))
        return out

    def _execute_amplitudes(self, entry: _StateEntry,
                            bits_arr: np.ndarray) -> torch.Tensor:
        """Batched amplitudes of one state (the caller holds the lock)."""
        self._touch(entry)
        B = bits_arr.shape[0]
        self._counters["queries_amplitude"] += B
        groups: Dict[tuple, List[int]] = {}
        for idx in range(B):
            prefix = tuple(tuple(int(b) for b in row)
                           for row in bits_arr[idx][:-1])
            groups.setdefault(prefix, []).append(idx)
        state = entry.state
        vals = torch.empty(B, dtype=state.dtype, device=state.device)
        for prefix, idxs in groups.items():
            env = self._prefix_env(entry, prefix)
            final_bits = bits_arr[idxs, -1, :]
            done = 0
            for bucket in self._chunks(len(idxs)):
                take = min(bucket, len(idxs) - done)
                chunk = final_bits[done:done + take]
                if take < bucket:  # pad by repeating the first query
                    pad = np.broadcast_to(chunk[0], (bucket - take,
                                                     chunk.shape[1]))
                    chunk = np.concatenate([chunk, pad], axis=0)
                    self._counters["padded_queries"] += bucket - take
                out = final_row_amplitudes(env, state.sites[-1], chunk,
                                           state.log_scale)
                dst = torch.as_tensor(idxs[done:done + take],
                                      device=state.device)
                vals[dst] = out[:take]
                done += take
        self._counters["batches"] += 1
        return vals

    def _obs_envs(self, entry: _StateEntry):
        if entry.obs_envs is None:
            entry.obs_envs = row_environments(entry.state, entry.option,
                                              entry.env_key)
            entry.obs_env_builds += 1
        else:
            entry.obs_env_hits += 1
        return entry.obs_envs

    def _execute_expectation(self, entry: _StateEntry,
                             obs: Observable) -> torch.Tensor:
        self._touch(entry)
        self._counters["queries_expectation"] += 1
        top, bottom = self._obs_envs(entry)
        return expectation_from_envs(entry.state, obs, top, bottom)

    # -- dispatcher ---------------------------------------------------------

    def _dispatch_loop(self):
        while True:
            try:
                first = self._queue.get(timeout=0.1)
            except _queuelib.Empty:
                if self._closed:
                    return
                continue
            if first is _SHUTDOWN:
                # keep draining: requests enqueued before close() resolve
                if self._queue.empty():
                    return
                self._queue.put(_SHUTDOWN)
                continue
            batch = [first]
            deadline = time.monotonic() + self.window_ms / 1e3
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except _queuelib.Empty:
                    break
                if nxt is _SHUTDOWN:
                    self._queue.put(_SHUTDOWN)
                    break
                batch.append(nxt)
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]):
        """Group a dispatch cycle by state and kind, and execute under the
        lock.  Each state entry is resolved after the lock is taken, so a
        ``register_state`` that returned before is always honored.  An
        error reaches every future of its group, never a hang."""
        amp_groups: Dict[str, List[_Request]] = collections.OrderedDict()
        exp_reqs: List[_Request] = []
        for req in batch:
            if req.kind == "amplitude":
                amp_groups.setdefault(req.name, []).append(req)
            else:
                exp_reqs.append(req)
        with self._lock:
            for name, reqs in amp_groups.items():
                try:
                    entry = self._entry(name)
                    bits_arr = np.stack([
                        self._check_single(entry, r.payload) for r in reqs])
                    vals = self._execute_amplitudes(entry, bits_arr)
                except Exception as e:  # noqa: BLE001 — delivered per future
                    for r in reqs:
                        _resolve(r.future, error=e)
                    continue
                for r, v in zip(reqs, vals):
                    _resolve(r.future, v)
            for req in exp_reqs:
                try:
                    val = self._execute_expectation(self._entry(req.name),
                                                    req.payload)
                except Exception as e:  # noqa: BLE001
                    _resolve(req.future, error=e)
                    continue
                _resolve(req.future, val)
