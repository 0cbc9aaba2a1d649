"""Contraction-path search and cache, and the per-signature solver cache.

Counterpart of ``repro.core.planner``.  Two memoization layers keyed by a
**network signature** ``(subscripts, shapes, dtypes, row, col)``:

1. **Path cache** — :func:`contraction_path` memoizes the pairwise
   contraction order of an einsum expression over operand shapes;
   :func:`cached_einsum` executes it as a sequence of pairwise
   ``torch.einsum`` calls.  The search is the port's own (the card's
   machine has no ``opt_einsum``, and ``torch.einsum`` with many operands
   contracts left to right without it): an exact dynamic program over
   operand subsets that minimizes the flop count of the contraction tree,
   with ``opt_einsum``'s cost model (``size of the pair's index union``,
   doubled when an index is summed).  It is exact for any operand count,
   so it covers both the reference's ``"optimal"`` (<= 6 operands) and
   ``"dp"`` (more) searches.
2. **Fused-solver cache** — :func:`fused_fn` / :func:`fused_randomized_svd`
   cache one callable per signature plus the dispatch state.  PyTorch runs
   eagerly, so nothing is compiled; the cache keeps the reference's
   structure and counters, and is where a CUDA-graph capture would go.

Hit/miss counters (:func:`stats`) tick at Python call time.  Several
threads may fill the caches at once (the worker threads of
:mod:`repro_torch.core.spmd`): a lookup, its miss and its fill happen under
one lock, so a signature misses once whatever the threads' order, and the
counters tick under :data:`repro_torch.counting.LOCK`.
:func:`disabled` switches both layers off.  :func:`save_path_cache` /
:func:`load_path_cache` persist the path cache across processes.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import warnings
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import counting
from repro_torch.kernels import dispatch as _dispatch

_CONFIG = {"path_cache": True, "fusion": True}

_PATH_CACHE: Dict[tuple, list] = {}
_FUSED_CACHE: Dict[tuple, object] = {}
# held from a cache lookup through its fill (reentrant: a ``make`` may
# reach the path cache)
_CACHE_LOCK = threading.RLock()

_COUNTERS = {
    "path_hits": 0,
    "path_misses": 0,
    "path_uncached": 0,    # path searches with the cache disabled
    "path_preloaded": 0,   # entries installed by load_path_cache
    "fused_hits": 0,
    "fused_misses": 0,
}


def stats() -> Dict[str, int]:
    """Current cache counters + sizes + kernel-dispatch counters + runtime
    guard counters (copies)."""
    from repro_torch.core import runtime_guard
    with counting.LOCK:
        out = dict(_COUNTERS)
    out["path_cache_size"] = len(_PATH_CACHE)
    out["fused_cache_size"] = len(_FUSED_CACHE)
    out.update(_dispatch.dispatch_stats())
    out.update(runtime_guard.global_counters())
    return out


def stats_since(before: Dict[str, int]) -> Dict[str, int]:
    """Counter deltas relative to an earlier :func:`stats` snapshot (cache
    sizes stay absolute)."""
    now = stats()
    return {k: v if k.endswith("_cache_size") else v - before.get(k, 0)
            for k, v in now.items()}


def reset_stats() -> None:
    from repro_torch.core import runtime_guard
    with counting.LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
    _dispatch.reset_dispatch_stats()
    runtime_guard.reset_global_counters()


def clear() -> None:
    """Drop both caches (and counters)."""
    with _CACHE_LOCK:
        _PATH_CACHE.clear()
        _FUSED_CACHE.clear()
    reset_stats()


@contextlib.contextmanager
def disabled():
    """Temporarily switch off the path cache and the fused cache."""
    prev = dict(_CONFIG)
    _CONFIG["path_cache"] = False
    _CONFIG["fusion"] = False
    try:
        yield
    finally:
        _CONFIG.update(prev)


def configure(*, path_cache: bool = None, fusion: bool = None) -> Dict[str, bool]:
    """Flip individual layers; returns the previous configuration."""
    prev = dict(_CONFIG)
    if path_cache is not None:
        _CONFIG["path_cache"] = path_cache
    if fusion is not None:
        _CONFIG["fusion"] = fusion
    return prev


def network_signature(subscripts: Sequence[str],
                      shapes: Sequence[Tuple[int, ...]],
                      dtypes: Sequence, row: str, col: str) -> tuple:
    """Hashable identity of an einsumsvd subnetwork."""
    return (
        tuple(subscripts),
        tuple(tuple(s) for s in shapes),
        tuple(str(d).replace("torch.", "") for d in dtypes),
        row,
        col,
    )


# --------------------------------------------------------------------------
# Path search
# --------------------------------------------------------------------------

def _parse(expr: str) -> Tuple[List[str], str]:
    lhs, out = expr.split("->")
    return lhs.split(","), out


def _pair_cost(legs_a: frozenset, legs_b: frozenset, legs_out: frozenset,
               sizes: Dict[str, int]) -> int:
    """opt_einsum's flop count of one pairwise contraction."""
    union = legs_a | legs_b
    n = 1
    for c in union:
        n *= sizes[c]
    return n * 2 if union - legs_out else n


def search_path(inputs: Sequence[str], output: str,
                sizes: Dict[str, int]) -> List[Tuple[int, int]]:
    """Flop-optimal pairwise contraction order, in opt_einsum's linear
    format: each step names two positions of the current operand list,
    which are removed, and the result is appended at the end.

    Exact dynamic program over operand subsets (``3^n`` split
    enumerations): fine for the <= 10-operand networks of the library."""
    n = len(inputs)
    if n < 2:
        return []
    full = (1 << n) - 1
    out_set = frozenset(output)
    union = [frozenset()] * (1 << n)
    for mask in range(1, 1 << n):
        low = mask & -mask
        union[mask] = union[mask ^ low] | frozenset(inputs[low.bit_length() - 1])

    # the open legs of each subset's contraction: a leaf keeps all its own
    # indices, a larger subset those shared with the output or the rest
    legs = [union[mask] & (out_set | union[full ^ mask])
            for mask in range(1 << n)]
    for i in range(n):
        legs[1 << i] = frozenset(inputs[i])

    best: Dict[int, Tuple[int, tuple]] = {1 << i: (0, ()) for i in range(n)}
    for mask in sorted(range(1, full + 1), key=lambda m: bin(m).count("1")):
        if mask & (mask - 1) == 0:
            continue
        low = mask & -mask
        legs_m = legs[mask]
        choice = None
        sub = (mask - 1) & mask
        while sub:
            if sub & low:
                other = mask ^ sub
                cost = (best[sub][0] + best[other][0]
                        + _pair_cost(legs[sub], legs[other], legs_m, sizes))
                if choice is None or cost < choice[0]:
                    choice = (cost, (sub, other))
            sub = (sub - 1) & mask
        best[mask] = choice

    steps: List[Tuple[int, int]] = []

    def emit(mask: int) -> None:
        if mask & (mask - 1) == 0:
            return
        sub, other = best[mask][1]
        emit(sub)
        emit(other)
        steps.append((sub, other))

    emit(full)
    ops = [1 << i for i in range(n)]
    path = []
    for sub, other in steps:
        i, j = ops.index(sub), ops.index(other)
        path.append((min(i, j), max(i, j)))
        for k in sorted((i, j), reverse=True):
            ops.pop(k)
        ops.append(sub | other)
    return path


def contraction_path(expr: str, shapes: Tuple[Tuple[int, ...], ...]) -> list:
    """Flop-optimal contraction path for ``expr`` over ``shapes``, memoized
    on ``(expr, shapes)``."""
    key = (expr, shapes)
    if not _CONFIG["path_cache"]:
        counting.tick(_COUNTERS, "path_uncached")
        return _search(expr, shapes)
    with _CACHE_LOCK:
        hit = _PATH_CACHE.get(key)
        if hit is not None:
            counting.tick(_COUNTERS, "path_hits")
            return hit
        counting.tick(_COUNTERS, "path_misses")
        path = _PATH_CACHE[key] = _search(expr, shapes)
    return path


def _search(expr: str, shapes: Tuple[Tuple[int, ...], ...]) -> list:
    inputs, output = _parse(expr)
    sizes = {}
    for sub, shape in zip(inputs, shapes):
        sizes.update(zip(sub, shape))
    return search_path(inputs, output, sizes)


def execute_path(expr: str, path, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract ``tensors`` along ``path`` with pairwise ``torch.einsum``."""
    inputs, output = _parse(expr)
    ops = list(zip(tensors, inputs))
    for step in path:
        i, j = sorted(step, reverse=True)
        tb, lb = ops.pop(i)
        ta, la = ops.pop(j)
        keep = set(output).union(*(l for _, l in ops))
        lo = "".join(c for c in dict.fromkeys(la + lb) if c in keep)
        ops.append((torch.einsum(f"{la},{lb}->{lo}", ta, tb), lo))
    (t, labels), = ops
    if labels != output:
        t = torch.einsum(f"{labels}->{output}", t)
    return t


def cached_einsum(expr: str, *tensors: torch.Tensor) -> torch.Tensor:
    """``einsum`` along a plan-cached optimal path."""
    path = contraction_path(expr, tuple(tuple(t.shape) for t in tensors))
    return execute_path(expr, path, tensors)


# --------------------------------------------------------------------------
# Persistent path cache
# --------------------------------------------------------------------------
#
# A restarted process skips every path search by preloading the paths of an
# earlier one.  The file is JSON with a sha256 checksum over the
# canonicalized entries and a format version.  A missing file is a silent
# cold start; any other unusable file (truncated, bad checksum, unknown
# version, bad JSON) cold-starts with a RuntimeWarning, never an exception.

PATH_CACHE_FORMAT = 1


def _path_entries_canonical(entries: list) -> str:
    return json.dumps(entries, sort_keys=True, separators=(",", ":"))


def save_path_cache(path: str) -> int:
    """Write the in-memory path cache to ``path`` (atomic: a temporary
    file, then ``os.replace``).  Returns the number of entries written."""
    with _CACHE_LOCK:
        items = list(_PATH_CACHE.items())
    entries = sorted(
        [expr, [list(s) for s in shapes], [list(step) for step in plan]]
        for (expr, shapes), plan in items)
    payload = {
        "format": PATH_CACHE_FORMAT,
        "checksum": hashlib.sha256(
            _path_entries_canonical(entries).encode()).hexdigest(),
        "entries": entries,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return len(entries)


def load_path_cache(path: str) -> int:
    """Preload contraction paths from ``path``.  Returns the number of
    entries installed (0 on a missing or unusable file).  Installed entries
    tick ``path_preloaded``; later lookups of them count as hits."""
    try:
        with open(path) as f:
            payload = json.load(f)
        if payload["format"] != PATH_CACHE_FORMAT:
            raise ValueError(f"unknown path-cache format {payload['format']!r}")
        entries = payload["entries"]
        digest = hashlib.sha256(
            _path_entries_canonical(entries).encode()).hexdigest()
        if digest != payload["checksum"]:
            raise ValueError("path-cache checksum mismatch")
        staged = {}
        for expr, shapes, plan in entries:
            if not isinstance(expr, str):
                raise ValueError("path-cache entry: expr must be a string")
            key = (expr, tuple(tuple(int(d) for d in s) for s in shapes))
            staged[key] = [tuple(int(i) for i in step) for step in plan]
    except FileNotFoundError:
        return 0
    except (OSError, ValueError, KeyError, TypeError) as e:
        warnings.warn(f"ignoring unusable planner path cache {path!r} "
                      f"({e!r}): cold start", RuntimeWarning)
        return 0
    with _CACHE_LOCK:
        _PATH_CACHE.update(staged)
    counting.tick(_COUNTERS, "path_preloaded", len(staged))
    return len(staged)


_INT_LABELS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def int_einsum(*args) -> torch.Tensor:
    """Interleaved-format einsum with integer labels, along a cached path.

    ``int_einsum(t0, labels0, t1, labels1, ..., out_labels)``.  The labels
    are remapped to a canonical subscript string, so structurally equal
    networks built from different label counters share one cache entry.
    Networks with more than 52 distinct labels raise ValueError."""
    *pairs, out = args
    tensors = list(pairs[0::2])
    labels = list(pairs[1::2])
    mapping: Dict = {}

    def lab(ls):
        for l in ls:
            if l not in mapping:
                if len(mapping) == len(_INT_LABELS):
                    raise ValueError("int_einsum: more than 52 distinct labels")
                mapping[l] = _INT_LABELS[len(mapping)]
        return "".join(mapping[l] for l in ls)

    expr = ",".join(lab(ls) for ls in labels) + "->" + lab(out)
    return cached_einsum(expr, *tensors)


# --------------------------------------------------------------------------
# Callable caches per signature
# --------------------------------------------------------------------------

def fused_fn(tag: str, signature: tuple, make):
    """Memoized callable per ``(tag,) + signature``; ``make()`` runs once
    per distinct signature.  With fusion disabled its result is neither
    cached nor counted."""
    if not _CONFIG["fusion"]:
        return make()
    key = (tag,) + tuple(signature)
    with _CACHE_LOCK:
        fn = _FUSED_CACHE.get(key)
        if fn is not None:
            counting.tick(_COUNTERS, "fused_hits")
            return fn
        counting.tick(_COUNTERS, "fused_misses")
        fn = _FUSED_CACHE[key] = make()
    return fn


def _build_fused(subscripts: Tuple[str, ...], row: str, col: str,
                 rank: int, n_iter: int, oversample: int, gram_final: bool,
                 wide_svd: bool):
    from repro_torch.core.rsvd import ImplicitOperator, randomized_svd

    def run(tensors: List[torch.Tensor], key):
        op = ImplicitOperator(tensors, list(subscripts), row, col)
        return randomized_svd(op, rank, n_iter=n_iter, oversample=oversample,
                              key=key, gram_final=gram_final,
                              wide_svd=wide_svd)

    return run


def fused_randomized_svd(op, rank: int, n_iter: int = 4, oversample: int = 8,
                         key=None, gram_final: bool = True,
                         wide_svd: bool = False):
    """Randomized SVD of an ``ImplicitOperator`` through the per-signature
    callable cache; numerically identical to ``rsvd.randomized_svd``."""
    from repro_torch.core.rsvd import randomized_svd
    if not _CONFIG["fusion"]:
        return randomized_svd(op, rank, n_iter=n_iter, oversample=oversample,
                              key=key, gram_final=gram_final,
                              wide_svd=wide_svd)
    sig = network_signature(op.subscripts, [t.shape for t in op.tensors],
                            [t.dtype for t in op.tensors], op.row, op.col)
    sig = sig + (rank, n_iter, oversample, gram_final, wide_svd,
                 _dispatch.backend_signature(), op.device.type)
    fn = fused_fn("randomized_svd", sig,
                  lambda: _build_fused(tuple(op.subscripts), op.row, op.col,
                                       rank, n_iter, oversample, gram_final,
                                       wide_svd))
    return fn(list(op.tensors), key)
