"""Distributed sort-serving: MeshBankPool vs the single-process BankPool.

The twin of the reference's ``benchmarks/distserve_bench.py`` on the
port's engine.  Serves the same seeded workload through the local
``colskip`` engine and the mesh-sharded ``colskip_mesh`` engine (four
banks; on the card the mesh kernel, a thread-block cluster a row and a
CTA a bank, the OR-gates an exchange in distributed shared memory) and
reports tiles/s for each, plus the §V.C invariant that distribution must
not change the modeled hardware: the derived column carries
``cycle_parity=ok`` only when both engines exported identical exact-cycle
and column-read telemetry.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only distserve

On the CPU it serves fewer, narrower requests (12 of widths 32 and 64
instead of 48 of widths 64 to 256): the plain colskip machine is slow on
the host.
"""

from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.sortserve import EngineConfig, SortRequest, SortServeEngine

from .paper_common import submit_timed


def _workload(rng, n_requests: int, lens=(64, 128, 256)):
    reqs = []
    for i in range(n_requests):
        n = int(rng.choice(lens))
        payload = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        if i % 3 == 2:
            reqs.append(SortRequest("kmin", payload, k=int(rng.integers(1, 9))))
        else:
            reqs.append(SortRequest("sort", payload))
    return reqs


def _engine(mesh: bool, device) -> SortServeEngine:
    return SortServeEngine(EngineConfig(
        backends=("colskip_mesh",) if mesh else ("colskip",),
        mesh=mesh, tile_rows=8, banks=8, bank_width=256,
        sim_width_cap=4096, cache_size=0, device=device))


def _serve(mesh: bool, reqs, device):
    """Build the launchers on a throwaway engine, then measure a fresh
    one."""
    _engine(mesh, device).submit([SortRequest(q.op, q.payload.copy(), k=q.k)
                                  for q in reqs])
    engine = _engine(mesh, device)
    dt = submit_timed(engine, [SortRequest(q.op, q.payload.copy(), k=q.k)
                               for q in reqs], device)
    return dt, engine.telemetry()


def run(report, device="cuda"):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    reqs = (_workload(rng, 48) if dev.type == "cuda"
            else _workload(rng, 12, lens=(32, 64)))

    dt_local, tl = _serve(False, reqs, dev)
    dt_mesh, tm = _serve(True, reqs, dev)

    parity = ("ok" if tl["cycles_exact"] == tm["cycles_exact"]
              and tl["column_reads"] == tm["column_reads"] else
              f"MISMATCH local={tl['cycles_exact']} mesh={tm['cycles_exact']}")
    n_banks = tm["scheduler"]["banks"]
    for name, dt, telem in (("distserve_local_pool", dt_local, tl),
                            ("distserve_mesh_pool", dt_mesh, tm)):
        tiles = telem["batcher"]["tiles"]
        report(name, dt / max(tiles, 1) * 1e6,
               f"tiles_per_s={tiles / dt:.1f} req={telem['requests']} "
               f"cycles={telem['cycles_exact']} banks={len(n_banks)} "
               f"cycle_parity={parity}")
