"""PEPS query server: batched amplitude/observable serving CLI.

Counterpart of ``repro.launch.serve``.  Stands up a
:class:`repro_torch.core.serving.ServingEngine` over one or more hot
RQC-evolved PEPS states, fires threaded clients at it, and reports latency
percentiles, throughput, and the speedup over per-query cold contraction.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --grid 4 --layers 8 --chi 8 --states 2 \\
        --clients 4 --queries 32 --hot-prefixes 4 --obs-every 8

Each client thread submits ``--queries`` requests against randomly chosen
registered states.  Amplitude bitstrings draw their row prefix from a
per-state pool of ``--hot-prefixes`` prefixes, with uniformly random final
rows; every ``--obs-every``-th request is an observable query instead.  The
states live on ``--device`` (the CUDA card by default; ``cpu`` on request)
in ``--dtype``.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core import bmps as B
from repro_torch.core.circuits import apply_circuit_exact_peps, random_circuit
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD
from repro_torch.core.observable import Observable
from repro_torch.core.peps import computational_zeros
from repro_torch.core.serving import ServingEngine
from repro_torch.device import resolve_device

_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def _percentiles(lat_s):
    lat = np.sort(np.asarray(lat_s)) * 1e3
    if lat.size == 0:
        return "n/a"
    pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
    return (f"p50={pick(0.50):.2f}ms p95={pick(0.95):.2f}ms "
            f"p99={pick(0.99):.2f}ms")


def build_states(n_states: int, grid: int, layers: int, seed: int = 7,
                 dtype=torch.complex128, device=None):
    """RQC-evolve ``n_states`` hot PEPS states (exact evolution, bond
    4^(layers/4)), circuit seeds ``seed``, ``seed + 1``, ..."""
    return [apply_circuit_exact_peps(
                computational_zeros(grid, grid, dtype=dtype, device=device),
                random_circuit(grid, grid, layers, seed=seed + s))
            for s in range(n_states)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=4, help="grid side (NxN PEPS)")
    ap.add_argument("--layers", type=int, default=8, help="RQC layers")
    ap.add_argument("--chi", type=int, default=8, help="contraction bond dim")
    ap.add_argument("--svd", choices=("direct", "randomized"),
                    default="direct")
    ap.add_argument("--engine", choices=("zipup", "variational"),
                    default="zipup")
    ap.add_argument("--states", type=int, default=2,
                    help="number of hot states to register")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent client threads")
    ap.add_argument("--queries", type=int, default=32,
                    help="queries per client")
    ap.add_argument("--hot-prefixes", type=int, default=4,
                    help="per-state pool of hot row prefixes")
    ap.add_argument("--obs-every", type=int, default=8,
                    help="every k-th request is an observable query (0 = none)")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="dispatcher micro-batching window")
    ap.add_argument("--max-states", type=int, default=4,
                    help="states with materialized caches (LRU)")
    ap.add_argument("--baseline-queries", type=int, default=8,
                    help="cold per-query contractions for the speedup line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the states ('cuda' or 'cpu')")
    ap.add_argument("--dtype", choices=tuple(_DTYPES), default="complex128")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    svd = (DirectSVD() if args.svd == "direct" else
           RandomizedSVD(niter=4, oversample=8))
    option = B.BMPS(args.chi, svd, engine=args.engine)

    t0 = time.perf_counter()
    states = build_states(args.states, args.grid, args.layers,
                          dtype=_DTYPES[args.dtype], device=device)
    _sync(device)
    print(f"[serve] {args.states} x {args.grid}x{args.grid} RQC states "
          f"(bond {states[0].max_bond()}, {args.dtype} on {device}) evolved "
          f"in {time.perf_counter()-t0:.1f}s")

    engine = ServingEngine(max_states=args.max_states,
                           window_ms=args.window_ms)
    names = [f"rqc{s}" for s in range(len(states))]
    for name, st in zip(names, states):
        engine.register_state(name, st, option)

    # hot prefix pools: rows 0..n-2, per state
    rng = np.random.default_rng(args.seed)
    prefix_pool = {
        name: rng.integers(0, 2, (args.hot_prefixes, args.grid - 1, args.grid))
        for name in names}
    obs = Observable.Z(0) + Observable.ZZ(0, 1)

    # warm the prefix caches and the bucket closes once, so the measured run
    # is steady-state serving (cold start is reported separately)
    t0 = time.perf_counter()
    for name in names:
        warm = np.concatenate(
            [prefix_pool[name],
             rng.integers(0, 2, (args.hot_prefixes, 1, args.grid))], axis=1)
        engine.amplitude_batch(name, warm)
    _sync(device)
    print(f"[serve] warmup (prefix envs + bucket closes): "
          f"{time.perf_counter()-t0:.1f}s")

    amp_lat, obs_lat = [], []
    lat_lock = threading.Lock()

    def client(cid: int):
        crng = np.random.default_rng(1000 + cid)
        pending = []
        for q in range(args.queries):
            name = names[crng.integers(len(names))]
            if args.obs_every and (q + 1) % args.obs_every == 0:
                t = time.perf_counter()
                pending.append(("obs", t, engine.submit_expectation(name, obs)))
            else:
                prefix = prefix_pool[name][crng.integers(args.hot_prefixes)]
                final = crng.integers(0, 2, (1, args.grid))
                bits = np.concatenate([prefix, final], axis=0)
                t = time.perf_counter()
                pending.append(("amp", t, engine.submit_amplitude(name, bits)))
        for kind, t, fut in pending:
            fut.result(timeout=600)
            with lat_lock:
                (amp_lat if kind == "amp" else obs_lat).append(
                    time.perf_counter() - t)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total = len(amp_lat) + len(obs_lat)

    print(f"[serve] {total} queries from {args.clients} clients in "
          f"{wall:.2f}s -> {total / wall:.1f} q/s")
    print(f"[serve] amplitude latency ({len(amp_lat)}): "
          f"{_percentiles(amp_lat)}")
    if obs_lat:
        print(f"[serve] observable latency ({len(obs_lat)}): "
              f"{_percentiles(obs_lat)}")

    # cold per-query baseline: a full boundary sweep per amplitude
    nb = args.baseline_queries
    if nb > 0:
        bits = np.concatenate(
            [np.broadcast_to(prefix_pool[names[0]][0],
                             (nb, args.grid - 1, args.grid)),
             rng.integers(0, 2, (nb, 1, args.grid))], axis=1)
        t0 = time.perf_counter()
        for b in bits:
            B.amplitude(states[0], b, option)
        _sync(device)
        cold = (time.perf_counter() - t0) / nb
        t0 = time.perf_counter()
        engine.amplitude_batch(names[0], bits)
        _sync(device)
        served = (time.perf_counter() - t0) / nb
        print(f"[serve] per-query: cold contraction {cold*1e3:.2f}ms vs "
              f"served (warm cache, batched) {served*1e3:.2f}ms "
              f"-> x{cold / max(served, 1e-12):.1f}")

    st = engine.stats()
    flat = {k: v for k, v in st.items() if k != "per_state"}
    print(f"[serve] stats: {flat}")
    for name, ps in st["per_state"].items():
        print(f"[serve]   {name}: {ps}")
    engine.close()
    return st


if __name__ == "__main__":
    main()
