"""No run loads jax, jaxlib, flax or the JAX package ``repro``: the check
compares whole top-level names, and a whole run goes through where those
cannot be imported."""

import json
import subprocess
import sys
import textwrap

from _small import REPO, small_root
from perfbench import harness


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.sortserve", "jaxtyping",
                 "reproduce", "flaxen"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.sortserve", type(sys)("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", type(sys)("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "repro"]


def test_a_run_imports_none_of_them(tmp_path):
    blocked = tmp_path / "blocked"
    for name in ("jax", "jaxlib", "flax", "repro"):
        pkg = blocked / name
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text(
            f"raise ImportError('{name} may not be imported here')\n")
    (tmp_path / "root").mkdir()
    root = small_root(tmp_path / "root")
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(blocked)!r}, {str(REPO)!r},
                        {str(REPO / 'src')!r}]
        from perfbench import harness
        r = harness.run_cell({str(root)!r}, "csk.uniform1024.backlog",
                             3, 1.0, False, device="cpu")
        print(json.dumps({{"correct": r["correct"],
                          "loaded": harness.forbidden_modules()}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "loaded": []}
