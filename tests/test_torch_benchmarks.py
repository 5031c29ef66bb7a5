"""The port's benchmark harness vs the reference's, on the CPU.

  * the figure suites (numpy hardware models on the host) give the same
    row names and the same derived text as the JAX package's suites;
  * ``kernel_bench`` on ``cpu`` has no MISS and no error, and its
    planes-visited, pass-count and cycles-per-number fields equal the
    reference functions' on the same arrays (the radix rows get the JAX
    softmax array itself: ``torch.softmax`` may differ by an ulp, and
    planes visited read bits);
  * the copied ``core/multibank.py`` equals the reference's at the fig8b
    input, values and cycles;
  * the streaming and distserve suites on ``cpu`` (their CPU sizes): the
    reference's row names; the cycle-domain rows (arrival disciplines,
    overload, fleet scale-out) give the reference's derived text; every
    correctness band passes and ``cycle_parity=ok``;
  * the runner keeps the reference's document and exit code, and asks for
    the card by default.
"""

import importlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multibank_colskip_sort as ref_multibank
from repro.core.datasets import make_dataset
from repro.kernels.colskip import colskip_sort_batched as ref_sort_batched
from repro.kernels.radix_topk.kernel import threshold_pallas
from repro_torch.benchmarks import distserve_bench, kernel_bench
from repro_torch.benchmarks import run as bench_run
from repro_torch.benchmarks import streaming_bench
from repro_torch.core.multibank import multibank_colskip_sort

TIMES = re.compile(r"\b(dense_us|radix|torch_topk|lax|cold_us)=\S+")


def _rows(suite_run, **kw):
    rows = []
    suite_run(lambda name, us_per_call, derived:
              rows.append((name, derived)), **kw)
    return rows


@pytest.mark.parametrize("suite", ["fig6_speedup", "fig7_area_power",
                                   "fig8a_summary", "fig8b_multibank"])
def test_figure_suites_match_reference_text(suite):
    ref = importlib.import_module(f"benchmarks.{suite}")
    port = importlib.import_module(f"repro_torch.benchmarks.{suite}")
    want = _rows(ref.run)
    got = _rows(port.run, device="cpu")
    assert got == want
    assert all(d.endswith("PASS") for _, d in got)


def test_kernel_bench_on_cpu_passes_and_matches_reference_fields():
    rows = dict(_rows(kernel_bench.run, device="cpu"))
    assert len(rows) == 6 and not any("MISS" in d for d in rows.values())
    assert "passes=55 " in rows["kernel/bitonic_sort/mapreduce_1024"]
    # cycles per number: the reference's kernel on the same rows
    for ds in ("uniform", "mapreduce"):
        v = np.stack([make_dataset(ds, 128, 32, seed=s).astype(np.uint32)
                      for s in (1, 2)])
        cyc = np.asarray(ref_sort_batched(jnp.asarray(v), 32, 2,
                                          use_pallas=True, interpret=True)[3])
        assert rows[f"kernel/colskip_sort/{ds}"].startswith(
            f"cyc/num={float(cyc.mean()) / 128:.2f} ")
    # planes visited: both packages on the same arrays
    rng = np.random.default_rng(0)
    cases = {
        "router_probs": np.asarray(jax.nn.softmax(jnp.asarray(
            rng.normal(size=(64, 128)).astype(np.float32)))),
        "logits_wide": (rng.normal(size=(64, 128)) * 10.0).astype(np.float32),
    }
    for name, arr in cases.items():
        _, visited = threshold_pallas(jnp.asarray(arr), 8, interpret=True)
        got = []
        kernel_bench.radix_row(lambda **r: got.append(r["derived"]), name,
                               arr, torch.device("cpu"))
        top = int(np.asarray(visited).max())
        assert got[0] == f"planes_visited={top}/32 skip={1 - top / 32:.2f} PASS"


@pytest.mark.parametrize("banks", [2, 4, 16])
def test_multibank_copy_matches_reference(banks):
    v = make_dataset("mapreduce", 1024, 32, seed=3)
    got = multibank_colskip_sort(v, 32, 2, banks)
    want = ref_multibank(v, 32, 2, banks)
    assert np.array_equal(got.values, want.values)
    assert np.array_equal(got.order, want.order)
    assert (got.cycles, got.column_reads, got.drains, got.iterations) == \
        (want.cycles, want.column_reads, want.drains, want.iterations)


def test_runner_document_and_exit_code(tmp_path, capsys, monkeypatch):
    out = tmp_path / "bench.json"
    assert bench_run.main(["--device", "cpu", "--only", "fig8a", "--json",
                           "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == doc
    assert [r["name"] for r in doc["rows"]] == [
        "fig8a/baseline", "fig8a/merge", "fig8a/colskip_k2",
        "fig8a/colskip_k2_Ns64"]
    assert doc["band_misses"] == 0 and doc["errors"] == []
    # a suite that raises is reported and makes the exit code 1
    monkeypatch.setattr(bench_run, "SUITES",
                        bench_run.SUITES + ["repro_torch.benchmarks.absent"])
    assert bench_run.main(["--device", "cpu", "--only", "absent"]) == 1
    assert "ERROR" in capsys.readouterr().out


def test_runner_ports_eight_suites_and_asks_for_the_card(monkeypatch):
    # eight suites at first; streaming and distserve since: ten of eleven
    names = [m.rsplit(".", 1)[1] for m in bench_run.SUITES]
    assert names == ["fig6_speedup", "fig7_area_power", "fig8a_summary",
                     "fig8b_multibank", "kernel_bench", "serving_bench",
                     "sortserve_bench", "packed_bench", "streaming_bench",
                     "distserve_bench"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_run.main(["--only", "fig8a"])


# cycle-domain rows: a deterministic simulation, the same text in both
_MODEL_ROWS = ("streaming/poisson_", "streaming/bursty_",
               "streaming/overload_", "streaming/fleet_1replica",
               "streaming/fleet_2replica", "streaming/fleet_scaleout")


def test_streaming_suite_on_cpu_matches_reference_rows():
    from benchmarks import streaming_bench as ref
    got = dict(_rows(streaming_bench.run, device="cpu"))
    want = []
    for part in (ref._bench_overload, ref._bench_fleet):
        part(lambda name, us_per_call, derived: want.append((name, derived)))
    for discipline, trace, window in (
            ("poisson", ref.poisson_trace(400, seed=11, mean_gap=2400.0),
             4000.0),
            ("bursty", ref.bursty_trace(40, gap=40_000.0), 8000.0)):
        ref._bench_discipline(
            lambda name, us_per_call, derived: want.append((name, derived)),
            discipline, trace, window)
    names = ["poisson_continuous", "poisson_flush", "poisson_speedup",
             "bursty_continuous", "bursty_flush", "bursty_speedup",
             "overload_off", "overload_defer", "overload_shed",
             "overload_backpressure", "session_local", "tracing_overhead",
             "export_overhead", "degraded_healthy", "degraded_dead_bank",
             "degraded_transient_storm", "degraded_recovery",
             "fleet_1replica", "fleet_2replica", "fleet_scaleout",
             "fleet_steady", "fleet_rolling", "fleet_rolling_restart",
             "session_mesh"]
    assert list(got) == [f"streaming/{n}" for n in names]
    for name, derived in want:
        assert name.startswith(_MODEL_ROWS)
        assert got[name] == derived, name
    # correctness bands: every request served (sessions, the degraded
    # ladder, the fleet); the wall-clock overhead bands are not asserted
    for name in ("session_local", "session_mesh", "degraded_recovery",
                 "fleet_rolling_restart", "fleet_scaleout"):
        assert got[f"streaming/{name}"].endswith("PASS"), name


def test_distserve_suite_on_cpu_keeps_cycle_parity():
    got = dict(_rows(distserve_bench.run, device="cpu"))
    assert list(got) == ["distserve_local_pool", "distserve_mesh_pool"]
    for derived in got.values():
        assert derived.endswith("cycle_parity=ok")
    assert got["distserve_local_pool"].split()[1:4] == \
        got["distserve_mesh_pool"].split()[1:4]       # req, cycles, banks
