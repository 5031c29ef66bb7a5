"""Time the colskip (both carriers, one bank and the mesh) and radix
kernels against another checkout's.

    python3 scripts/kernel_variants.py --parent DIR [--iters 20]

Needs an NVIDIA card and nvcc (the port's build flags, ``sm_90a``).
``DIR`` is another checkout of the repo, for example an unpacked ``git
archive`` of an earlier commit.  Its ``colskip.cu``, ``colskip_mesh.cu``
(in its parts, as ``kernels/_build.py`` builds it) and
``radix_threshold.cu`` are built as they are (every nvcc process started
together) into ``build/kernel_variants/`` and held against the package's
own kernels (``colskip_sort_batched`` on both carriers,
``colskip_sort_mesh_batched``, ``threshold_sortable``, ``threshold_f32``:
every output equal; the mesh's exchange rounds may differ).  Each
pair is timed with CUDA events in the order (package, parent, parent,
package), so that drift shows as a gap between a build's two readings,
two ways: back to back (the host's enqueue of each call included) and on
the device alone (the calls queued behind a busy kernel of some
milliseconds, so that they run back to back on the card).  Shapes:

  * colskip, dense and packed carriers (w=32, k=2, full sort): the
    (8, 1024) mapreduce tile of the harness's ``packed_bench`` and an
    (8, 2048) uniform tile, the serving cap (PERF.md rows 1b and 1: each
    build's ratio to the parent is printed beside a 3 % mark);
  * the colskip mesh kernels (w=32, k=2, D = 4 banks, F = 2): both
    carriers on the (8, 2048) uniform tile (rows 1c and 1d) and the
    packed one on ``hw_bench``'s (1, 1024) row (row 1e);
  * radix threshold: the (8, 4096) k=32 sortable tile that
    ``chip_smoke.py`` times, the ``kernel_bench`` rows' (64, 128) float32
    k=8 inputs (softmax router probabilities, wide logits), the bank
    tiles of the ``serving_bench`` vocab rows ((8 * banks, 16384) float32,
    k=64, banks = ceil(vocab / 16384)), and the serving smoke's own radix
    tiles: the threshold kernel's input of every radix_topk tile the
    default smoke serves (recorded as ``scripts/radix_profile.py`` records
    them; the descent each fused top-k launch runs), one call launching
    all of them, so its time is their sum.

  * radix fused top-k (the package's ``radix_select_launch`` with no
    options; a parent that predates it, its ``radix_topk_launch``): the
    narrow instance at the
    sampler's manager passes ((1, 1024) and (2, 640) float32 k=64,
    (4, 64) k=16), the router's rows ((4, 40) and (8192, 40) k=8) and
    narrow sort-serving tiles ((8, 1024) k=32, (8, 300) k=17 sortable),
    and the block instance's fused entry at (8, 4096) k=32 beside the
    threshold entry of both builds (a parent before the block instance's
    top-k entry refuses that row, so only its threshold is timed).

The card's launch floor (an empty kernel launched as one radix tile) is
printed beside them.  It prints one line per shape and the card's name
and power limit.  Before the times it prints, for every kernel of
``colskip.cu`` whose code differs between the two builds, its registers
and spills (``-Xptxas -v``) and its SASS instruction count
(``cuobjdump -sass``) in each, with the opcodes whose counts differ.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from radix_profile import record_tiles  # noqa: E402
from repro_torch.benchmarks import hw_bench  # noqa: E402
from repro_torch.core.datasets import make_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.colskip import ops as colskip_ops  # noqa: E402
from repro_torch.kernels.radix_topk import ops as radix_ops  # noqa: E402

OUT = ROOT / "build" / "kernel_variants"
BUSY_ROUNDS = 1 << 20          # dependent warp rounds: some 20 ms of busy card
VP, I = ctypes.c_void_p, ctypes.c_int


def build_parent(parent: Path) -> tuple:
    """source name -> the parent checkout's library, built as it is (a
    source in ``_build.PARTS`` in its parts, linked), and source name ->
    the compiler's output."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in ("colskip", "colskip_mesh", "radix_threshold"):
        path = next(parent.glob(f"src/repro_torch/**/csrc/{src}.cu"))
        so = OUT / f"lib{src}_parent.so"
        cmds, objs = _build._commands(path.stem, path, so)
        procs[src] = (so, objs, [subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in cmds])
    libs, logs = {}, {}
    for src, (so, objs, running) in procs.items():
        log = logs[src] = "".join(proc.communicate()[0] for proc in running)
        if any(proc.returncode != 0 for proc in running):
            raise RuntimeError(f"nvcc failed for the parent's {src}:\n{log}")
        if objs:
            link = subprocess.run(
                [_build._nvcc(), "-shared", "-o", str(so), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"the parent's {src} did not link:\n"
                                   f"{link.stdout}")
        libs[src] = ctypes.CDLL(str(so))
    libs["colskip"].colskip_sort_launch.argtypes = [VP] * 5 + [I] * 6 + [VP]
    libs["colskip"].colskip_sort_launch.restype = I
    libs["colskip_mesh"].colskip_mesh_launch.argtypes = \
        [VP] * 6 + [I] * 8 + [VP]
    libs["colskip_mesh"].colskip_mesh_launch.restype = I
    libs["radix_threshold"].radix_threshold_launch.argtypes = \
        [VP, VP, VP] + [I] * 4 + [VP]
    libs["radix_threshold"].radix_threshold_launch.restype = I
    return libs, logs


def demangled(names) -> dict:
    """mangled -> demangled names (``cu++filt``), so that kernels in an
    anonymous namespace, whose mangled names differ from build to build,
    pair up."""
    names = sorted(set(names))
    filt = shutil.which("cu++filt") or str(
        Path(_build._nvcc()).parent / "cu++filt")
    out = subprocess.run([filt, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def ptxas_report(log: str) -> dict:
    """kernel (mangled name) -> its registers and spills, from a build's
    ``-Xptxas -v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (m.group(1) != "0" or m.group(2) != "0"):
            out[fn] = out.get(fn, "") + f" spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn] = f"{m.group(1)} regs" + out.get(fn, "")
    return out


def sass_opcodes(so: Path) -> dict:
    """kernel (mangled name) -> Counter of its SASS opcodes."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]"
                     r"[\w.]*)", line)
        if m and fn is not None:
            out[fn][m.group(1).split(".")[0]] += 1
    return out


def code_report(pkg: tuple, parent: tuple) -> None:
    """Print each kernel whose code differs between two builds, (library
    path, compiler output) each: registers, instructions, opcodes."""
    regs = [ptxas_report(log) for _, log in (pkg, parent)]
    ops = [sass_opcodes(so) for so, _ in (pkg, parent)]
    names = demangled([fn for d in regs + ops for fn in d])
    regs = [{names[fn]: v for fn, v in d.items()} for d in regs]
    ops = [{names[fn]: v for fn, v in d.items()} for d in ops]
    same_n = 0
    for fn in sorted(set(ops[0]) | set(ops[1])):
        a, b = (o.get(fn, collections.Counter()) for o in ops)
        ra, rb = (r.get(fn, "?") for r in regs)
        if a == b and ra == rb:
            same_n += 1
            continue
        diff = {op: a[op] - b[op] for op in set(a) | set(b) if a[op] != b[op]}
        top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:10]
        print(f"code {fn[:160]}: package {ra}, {sum(a.values())} "
              f"instructions; parent {rb}, {sum(b.values())}; opcodes "
              "package - parent: " + " ".join(f"{op} {d:+d}" for op, d in top))
    print(f"code: {same_n} kernels of the same registers and opcodes in both")


def topk_entry(lib):
    """``lib``'s fused top-k entry as ``f(x, vals, idxs, b, n, k, float_in,
    stream)``: ``radix_select_launch`` with no options, or in a library
    that predates it ``radix_topk_launch``, which takes those arguments."""
    try:
        fn = lib.radix_select_launch
    except AttributeError:
        fn = lib.radix_topk_launch
        fn.argtypes = [VP, VP, VP] + [I] * 4 + [VP]
        fn.restype = I
        return fn
    fn.argtypes = [VP] * 5 + [I] * 6 + [VP]
    fn.restype = I
    return lambda x, v, i, b, n, k, f, st: fn(x, v, i, None, None, b, n, k,
                                              0, 0, f, st)


def run_colskip(lib, x, w, k, packed):
    b, n = x.shape
    outs = (torch.empty((b, n), dtype=torch.uint32, device=x.device),
            torch.empty((b, n), dtype=torch.int32, device=x.device),
            torch.empty((b,), dtype=torch.int32, device=x.device),
            torch.empty((b,), dtype=torch.int32, device=x.device))
    err = lib.colskip_sort_launch(
        x.data_ptr(), *(o.data_ptr() for o in outs), b, n, w, k, n,
        int(packed), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"colskip launch failed: CUDA error {err}")
    return outs


def run_mesh(lib, x, banks, w, k, fuse, packed):
    """The mesh kernel: (values, order, CRs, cycles); its rounds apart."""
    b, n = x.shape
    outs = (torch.empty((b, n), dtype=torch.uint32, device=x.device),
            torch.empty((b, n), dtype=torch.int32, device=x.device),
            *(torch.empty((b,), dtype=torch.int32, device=x.device)
              for _ in range(3)))
    err = lib.colskip_mesh_launch(
        x.data_ptr(), *(o.data_ptr() for o in outs), b, n, banks, w, k, n,
        fuse, int(packed), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"colskip mesh launch failed: CUDA error {err}")
    return outs[:4]


def run_radix(lib, x, k, float_in):
    b, n = x.shape
    thresh = torch.empty((b,), dtype=torch.uint32, device=x.device)
    visited = torch.empty((b,), dtype=torch.int32, device=x.device)
    err = lib.radix_threshold_launch(
        x.data_ptr(), thresh.data_ptr(), visited.data_ptr(), b, n, k,
        int(float_in), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"radix launch failed: CUDA error {err}")
    return thresh, visited


def run_topk(entry, x, k):
    """The fused top-k entry (of :func:`topk_entry`): (values, indices)."""
    b, n = x.shape
    vals = torch.empty((b, k), dtype=x.dtype, device=x.device)
    idxs = torch.empty((b, k), dtype=torch.int32, device=x.device)
    err = entry(
        x.data_ptr(), vals.data_ptr(), idxs.data_ptr(), b, n, k,
        int(x.dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"radix top-k launch failed: CUDA error {err}")
    return vals, idxs


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time of one call: ``iters`` calls queued behind a busy
    kernel run back to back on the card, timed by the events around
    them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    colskip_ops.vote_chain(BUSY_ROUNDS)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def same(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32), v.view(torch.int32))
               for g, v in zip(got, want))


def rows(name: str, b: int, n: int, seed: int) -> torch.Tensor:
    x = np.stack([make_dataset(name, n, 32, seed=seed + r)
                  for r in range(b)]).astype(np.uint32)
    return torch.from_numpy(x).cuda()


def compare(label: str, builds: dict, fn, iters: int,
            mark: float | None = None) -> None:
    """Time fn(lib) for each build, in order and reversed: back to back,
    then on the device alone.  With ``mark``, each build's mean over the
    parent's beside it, and whether the package's is within ``mark``."""
    names = list(builds)
    for how, timer in (("back to back", time_ms), ("device", device_ms)):
        ms = {v: [] for v in names}
        for v in names + names[::-1]:
            ms[v].append(timer(lambda: fn(builds[v]), iters))
        line = f"{label} ({how}): " + "  ".join(
            f"{v} " + "/".join(f"{t:.5f}" for t in ms[v]) for v in names)
        if mark is not None:
            ratio = {v: sum(ms[v]) / sum(ms["parent"]) for v in names
                     if v != "parent"}
            line += "".join(f"  {v} / parent {r:.4f}"
                            for v, r in ratio.items())
            line += (f" (package within {mark:.0%}: "
                     f"{'yes' if ratio['package'] <= 1 + mark else 'no'})")
        print(line)


def smoke_radix_inputs() -> list:
    """(x, k) of the threshold descent for every radix_topk tile of the
    default serving smoke: the tile's sortable words (kmin: their
    complement), the descent that the tile's fused top-k launch runs
    first."""
    return [(torch.from_numpy(np.ascontiguousarray(
        ~data if kmin else data, np.uint32)).cuda(), k)
            for data, k, kmin in record_tiles()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card)
    parent, logs = build_parent(args.parent)
    src = _build.sources()["colskip"]
    code_report((_build._lib_path(src), _build.build_all(["colskip"])[
        "colskip"]), (OUT / "libcolskip_parent.so", logs["colskip"]))
    colskip = {"package": colskip_ops._lib(), "parent": parent["colskip"]}
    mesh = {"package": colskip_ops._mesh_lib(),
            "parent": parent["colskip_mesh"]}
    radix = {"package": radix_ops._lib(), "parent": parent["radix_threshold"]}
    topk = {name: topk_entry(lib) for name, lib in radix.items()}
    print("ms per call, each build timed twice (in order, then reversed)")

    # colskip on both carriers, full sorts at w=32, k=2
    for name, b, n, seed in (("mapreduce", 8, 1024, 0),
                             ("uniform", 8, 2048, 5)):
        x = rows(name, b, n, seed)
        for packed, carrier in ((False, "dense"), (True, "packed")):
            want = colskip_ops.colskip_sort_batched(x, 32, 2, packed=packed)
            if not same(run_colskip(parent["colskip"], x, 32, 2, packed),
                        want):
                raise RuntimeError(f"the parent's {carrier} kernel differs "
                                   f"at {name}")
            # a kernel of milliseconds a tile: fewer calls keep the busy
            # kernel ahead of the queue
            compare(f"{carrier} ({b}, {n}) {name} w=32 k=2", colskip,
                    lambda lib: run_colskip(lib, x, 32, 2, packed),
                    max(2, args.iters // 4), mark=0.03)

    # the mesh kernels at rows 1c, 1d (the (8, 2048) uniform tile) and 1e
    # (hw_bench's row), D = 4, F = 2
    x = rows("uniform", 8, 2048, 5)
    hw = torch.from_numpy(hw_bench.workload(1)[0].payload[None].copy()).cuda()
    for label, t, packed in (("packed (8, 2048) uniform", x, True),
                             ("dense (8, 2048) uniform", x, False),
                             ("packed (1, 1024) hw_bench", hw, True)):
        want = colskip_ops.colskip_sort_batched(t, 32, 2)
        for v, lib in mesh.items():
            if not same(run_mesh(lib, t, 4, 32, 2, 2, packed), want):
                raise RuntimeError(f"the {v}'s mesh kernel differs at "
                                   f"{label}")
        compare(f"mesh {label} D=4 F=2 w=32 k=2", mesh,
                lambda lib: run_mesh(lib, t, 4, 32, 2, 2, packed),
                max(2, args.iters // 4))

    # radix threshold
    rng = np.random.default_rng(11)
    u = torch.from_numpy(rng.integers(0, 1 << 32, (8, 4096), dtype=np.uint64)
                         .astype(np.uint32)).cuda()
    cases = [("(8, 4096) sortable k=32", u, 32, False)]
    rng = np.random.default_rng(0)             # kernel_bench's inputs
    logits = rng.normal(size=(64, 128)).astype(np.float32)
    cases.append(("(64, 128) router_probs f32 k=8",
                  torch.softmax(torch.from_numpy(logits), -1).cuda(), 8, True))
    cases.append(("(64, 128) logits_wide f32 k=8", torch.from_numpy(
        (rng.normal(size=(64, 128)) * 10.0).astype(np.float32)).cuda(), 8,
        True))
    for vocab in (32256, 151936, 262144):
        banks = -(-vocab // radix_ops.MAX_N)
        x = torch.from_numpy(np.random.default_rng(vocab).normal(
            size=(8 * banks, radix_ops.MAX_N)).astype(np.float32)).cuda()
        cases.append((f"({8 * banks}, {radix_ops.MAX_N}) vocab{vocab} bank "
                      "tiles f32 k=64", x, 64, True))
    for label, x, k, float_in in cases:
        want = (radix_ops.threshold_f32(x, k) if float_in
                else radix_ops.threshold_sortable(x, k))
        if not same(run_radix(parent["radix_threshold"], x, k, float_in),
                    want):
            raise RuntimeError(f"the parent's radix kernel differs at {label}")
        compare(f"radix {label}", radix,
                lambda lib: run_radix(lib, x, k, float_in), args.iters)

    # radix fused top-k: the narrow instance in both builds, then the
    # block instance's entry beside both builds' threshold entry
    rng = np.random.default_rng(1)
    cases = [(f"({b}, {n}) f32 k={k}", torch.from_numpy(
        rng.normal(size=(b, n)).astype(np.float32)).cuda(), k)
        for b, n, k in ((1, 1024, 64), (2, 640, 64), (4, 64, 16),
                        (4, 40, 8))]
    cases.append(("(8192, 40) f32 router k=8", torch.softmax(
        torch.from_numpy(rng.normal(size=(8192, 40)).astype(np.float32)),
        -1).cuda(), 8))
    cases += [(f"({b}, {n}) sortable k={k}", torch.from_numpy(rng.integers(
        0, 1 << 32, (b, n), dtype=np.uint64).astype(np.uint32)).cuda(), k)
        for b, n, k in ((8, 1024, 32), (8, 300, 17))]
    for label, x, k in cases:
        if not same(run_topk(topk["parent"], x, k),
                    run_topk(topk["package"], x, k)):
            raise RuntimeError(f"the parent's radix top-k differs at {label}")
        compare(f"radix narrow top-k {label}", topk,
                lambda entry: run_topk(entry, x, k), args.iters)
    compare("radix (8, 4096) sortable k=32: the package's fused top-k, "
            "then each build's threshold",
            {"fused": None, **radix},
            lambda lib: (run_topk(topk["package"], u, 32) if lib is None
                         else run_radix(lib, u, 32, False)), args.iters)

    smoke = smoke_radix_inputs()
    for x, k in smoke:
        if not same(run_radix(parent["radix_threshold"], x, k, False),
                    radix_ops.threshold_sortable(x, k)):
            raise RuntimeError("the parent's radix kernel differs on a smoke "
                               f"tile {tuple(x.shape)} k={k}")
    widths = sorted({x.shape[1] for x, _ in smoke})
    # some 40 launches a call: few calls keep the busy kernel ahead
    compare(f"radix, the smoke's {len(smoke)} tiles (widths {widths[0]} to "
            f"{widths[-1]}) in one call", radix,
            lambda lib: [run_radix(lib, x, k, False) for x, k in smoke],
            max(2, args.iters // 4))
    compare("empty kernel launched as one radix tile", {"floor": None},
            lambda _: radix_ops.empty_launch(), args.iters)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
