"""Replicated serving fleet demo on the PyTorch port: routing, failover,
warm-started restart (the twin of ``examples/fleet_serve.py``).

Run:  PYTHONPATH=src python examples/torch/fleet_serve.py [--device cpu]

Part 1 — **telemetry-driven routing**: three engine replicas behind a
:class:`FleetRouter` serve a mixed workload; placement follows the live
``window.*`` signals (queue depth, occupancy, shed rate) with
least-placed round-robin on ties, so the load spreads evenly — asserted
from the router's own ``fleet.*`` telemetry.

Part 2 — **failover**: one replica is killed mid-trace (the PR-8 fault
plumbing: a ``FaultPlan`` flipping every numpy execution into a hard
error) and the next batch still serves every request exactly once — the
failures are re-placed on the healthy siblings and the sick replica is
quarantined out of the placement set.

Part 3 — **warm-started restart**: the fleet's learned state (per-class
signature menus, cost-EMA priors, calibration rows) is saved as a
versioned JSON artifact (``save_warm_state``), the quarantined slot is
restarted with a fresh engine prewarmed from it, and the fleet snapshot
(``FleetRouter.snapshot()``) still folds the retired engine's counters —
nothing served is forgotten.  Every response of part 3 is checked
against the numpy oracle.  ``fleet_warm.json`` is written to the working
directory.  The replicas serve with the numpy backend, so ``--device``
only says where the engines would place their torch backends.
"""

import argparse
import dataclasses

from repro_torch.launch.sortserve import check_against_oracle, make_workload
from repro_torch.sortserve import (
    EngineConfig,
    FaultPlan,
    FleetRouter,
    RecoveryPolicy,
    SortServeEngine,
)


def replica(device):
    # numpy-only replicas keep the demo build-free, and the static cost
    # policy keeps placement at deterministic round-robin (with adaptive
    # routing on, measured cost EMAs also steer placement); the fleet
    # machinery is identical with the colskip/radix backends enabled
    return SortServeEngine(EngineConfig(
        backends=("numpy",), tile_rows=4, banks=4, bank_width=256,
        bank_rows=4, sim_width_cap=256, cache_size=0,
        adaptive_policy=False,
        faults=FaultPlan(seed=7, dead_banks=(0, 1, 2, 3),
                         targets=frozenset({"numpy"}), enabled=False,
                         recovery=RecoveryPolicy(max_retries=0)),
        device=device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    def make():
        return replica(args.device)

    router = FleetRouter([make() for _ in range(3)],
                         engine_factory=make, seed=0,
                         quarantine_s=30.0)

    # --- part 1: routing spreads the load -------------------------------
    reqs = make_workload(30, min_len=16, max_len=256, seed=1)
    resps, fails = router.serve(reqs, traffic_class="demo")
    assert not fails and all(r is not None for r in resps)
    fleet = router.telemetry()
    routed = {name: row["routed"] for name, row in fleet["per_replica"].items()}
    print(f"part 1: served {fleet['served']}/30 across {routed}")
    assert max(routed.values()) - min(routed.values()) <= 2, routed

    # --- part 2: kill replica0 mid-trace, failover serves everything ----
    sick = router.replicas[0].engine
    inj = sick._injector
    inj.plan = dataclasses.replace(inj.plan, enabled=True)   # every bank dead
    reqs2 = make_workload(30, min_len=16, max_len=256, seed=2)
    resps2, fails2 = router.serve(reqs2, traffic_class="demo")
    assert not fails2 and all(r is not None for r in resps2)
    fleet = router.telemetry()
    print(f"part 2: served {fleet['served'] - 30}/30 with "
          f"{fleet['failovers']} failovers; replica0 is "
          f"{fleet['per_replica']['replica0']['state']}")
    assert fleet["per_replica"]["replica0"]["state"] == "quarantined"

    # --- part 3: warm-started restart + fold-complete snapshot ----------
    ws = router.save_warm_state("fleet_warm.json")
    stats = router.restart(0, warm_state=ws)
    reqs3 = make_workload(30, min_len=16, max_len=256, seed=3)
    resps3, fails3 = router.serve(reqs3, traffic_class="demo")
    assert not fails3
    bad = sum(not check_against_oracle(q, r)
              for q, r in zip(reqs3, resps3) if r is not None)
    snap = router.snapshot()                 # retired engine folded in
    print(f"part 3: restarted replica0 warm ({stats['priors']} priors, "
          f"{stats['signatures']} signatures), served 30/30 more "
          f"(oracle mismatches: {bad}); fleet snapshot counts "
          f"{int(snap.counters['sortserve_requests_total'])} requests "
          f"-> fleet_warm.json")
    assert bad == 0
    assert int(snap.counters["sortserve_requests_total"]) == 90
    print("OK")


if __name__ == "__main__":
    main()
