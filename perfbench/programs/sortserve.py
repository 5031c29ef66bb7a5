"""The sort service, ``repro_torch.sortserve``: the program of the
column-skipping sorter's configurations (``"program": "sortserve"``).

Builds a ``SortServeEngine`` at the configuration's settings, snapshots its
telemetry, batcher counts and the mesh kernel's rounds at the window's
open and close, and checks every response against the plain reference of
:mod:`perfbench.reference.verify`, with the engine's result-cache hits
besides: each payload is new, so any hit is a fault.
"""

from __future__ import annotations

import time

from perfbench.harness import RunError

CR_SAMPLE = 512            # machine rows the open loop's check samples
OPS = {"sort", "argsort", "topk", "kmin"}
SETTINGS = ("backends", "tile_rows", "min_bucket", "banks", "bank_width",
            "bank_rows", "w", "state_k", "sim_width_cap", "mesh", "fuse",
            "cache_size", "packed", "guarantees")
MACHINES = ("colskip", "colskip_mesh")


def validate(config: dict) -> None:
    """Raises ValueError unless ``config`` states every setting the engine
    takes and a backend among its own for each of the four ops."""
    missing = [k for k in SETTINGS if k not in config]
    if config.get("mesh") and "mesh_banks" not in config:
        missing.append("mesh_banks")
    if missing:
        raise ValueError(f"{config.get('name')}: no {missing}")
    serves = config["guarantees"].get("serves", {})
    if set(serves) != OPS:
        raise ValueError(f"{config['name']}: guarantees.serves names "
                         f"{sorted(serves)}, not the ops {sorted(OPS)}")
    stray = {op: be for op, be in serves.items()
             if be not in config["backends"]}
    if stray:
        raise ValueError(f"{config['name']}: {stray} served by a backend "
                         "the configuration does not build")


def build(config: dict, device: str, cache_dir: str | None, tracer=None):
    """The program's engine at the configuration's settings."""
    from repro_torch.sortserve import EngineConfig, SortServeEngine
    cfg = EngineConfig(
        backends=tuple(config["backends"]), tile_rows=config["tile_rows"],
        min_bucket=config["min_bucket"], banks=config["banks"],
        bank_width=config["bank_width"], bank_rows=config["bank_rows"],
        w=config["w"], state_k=config["state_k"],
        sim_width_cap=config["sim_width_cap"], mesh=config["mesh"],
        fuse=config["fuse"], cache_size=config["cache_size"],
        packed=config["packed"], compile_cache=cache_dir, tracer=tracer,
        device=device)
    engine = SortServeEngine(cfg)
    if config["mesh"] and engine.pool.n_devices != config["mesh_banks"]:
        raise RunError(f"the mesh has {engine.pool.n_devices} banks, the "
                       f"configuration states {config['mesh_banks']}")
    return engine


def snapshot(engine) -> dict:
    """The engine's telemetry, the batcher's counts and the mesh kernel's
    rounds (a class-wide count)."""
    from repro_torch.sortserve.backends import ShardedColskipBackend
    bs = engine.batcher.stats
    return {"telemetry": engine.telemetry(),
            "batcher": {"tiles": bs.tiles, "requests": bs.requests,
                        "pad_cols": bs.pad_cols,
                        "real_elems": bs.real_elems},
            "mesh_rounds": ShardedColskipBackend.kernel_rounds}


def report(engine, log) -> None:
    exec_cache = engine.telemetry()["executor_cache"]
    log(f"kernel libraries opened from {engine.config.compile_cache}: "
        f"{exec_cache['persistent_hits']} from disk, "
        f"{exec_cache['persistent_misses']} built by nvcc in this run")


def check(window: dict, config: dict, marks: dict, *, seed: int, device,
          log) -> tuple[dict, dict, dict]:
    """Every response against the reference (:func:`verify.check`), and
    the result cache's hits in the window; every limit is 0.  The
    reference's column reads go to the roofline readers."""
    from perfbench.reference import verify
    t_ref = time.perf_counter()
    numbers, ref = verify.check(window, config, seed=seed, sample=CR_SAMPLE,
                                device=device)
    cache_hits = (marks["close"]["telemetry"]["cache"]["hits"]
                  - marks["open"]["telemetry"]["cache"]["hits"])
    log(f"engine result-cache hits in the window: {cache_hits} "
        "(any hit makes the run invalid)")
    log(f"reference: {time.perf_counter() - t_ref:.3f} s, "
        f"{ref['reads_checked']} rows' reads and cycles checked "
        f"({ref['machine_rows_sampled']} machine rows sampled)")
    numbers["cache_hits"] = cache_hits
    limits = dict(verify.LIMITS, cache_hits=0)
    return numbers, limits, {"expected_reads": ref["reads"]}


def control(engine, config: dict) -> None:
    """The control of ``correct``: the machine backends' tiles served by
    the plain reference at one state-recording entry fewer than the
    configuration states (k = 1 for the paper's k = 2): right values and
    positions, wrong column reads and cycles.  Column reads are kept by
    the row's sorted keys, which fix them."""
    import numpy as np

    from perfbench.reference.sortref import colskip_reads
    from repro_torch.sortserve.backends import TileResult
    w = engine.config.w
    state_k = config["state_k"] - 1
    memo: dict = {}

    def make_run(name):
        def run(tile):
            b, n = tile.data.shape
            stop = tile.k if tile.op == "kmin" else None
            out = n if stop is None else min(stop, n)
            vals = np.empty((b, out), np.uint32)
            idx = np.empty((b, out), np.int32)
            reads = np.empty(b, np.int64)
            cycles = np.empty(b, np.int64)
            for r in range(b):
                row = tile.data[r]
                order = np.argsort(row, kind="stable")[:out]
                vals[r], idx[r] = row[order], order
                key = (np.sort(row).tobytes(), stop)
                if key not in memo:
                    memo[key] = colskip_reads(row, w, state_k, stop)
                reads[r], cycles[r] = memo[key]
            return TileResult(vals, idx, reads, cycles, name,
                              meta={"exec_warm": True})
        return run

    for be in engine.backends:
        if be.name in MACHINES:
            be.run = make_run(be.name)
