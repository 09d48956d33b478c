"""Nothing the benchmark runs loads JAX, the JAX package or the
repository's scripts beside the port; the reference loads nothing of
the port.  Each check runs in a fresh process."""

import json
import subprocess
import sys

from conftest import BENCH, CHECKOUT

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracing_tpu", "bench_torch", "chip_smoke", "tools")


def _modules_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{BENCH!r}, {CHECKOUT!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=CHECKOUT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_of_each_loop_loads_nothing_forbidden():
    """A tiny CPU run of a render cell and of a train cell, traced, from
    the loop through the reference and the per-layer readers."""
    code = ("sys.path.insert(0, %r)\nfrom conftest import run_cell\n"
            "run_cell('zy_scene.render', 1, traced=True)\n"
            "run_cell('zy_scene.train', 2, traced=True)\n") % (BENCH + "/tests")
    names = _modules_after(code)
    assert "ray_tracing_tpu_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    code = ("import reference.render, reference.train, reference.compiler\n"
            "from harness import seeds, roofline\n")
    names = _modules_after(code)
    assert "reference" in names
    assert not names & {"ray_tracing_tpu_torch", *FORBIDDEN}


def test_the_report_names_forbidden_modules():
    from harness.report import FORBIDDEN as REPORTED, forbidden_modules

    assert set(REPORTED) == set(FORBIDDEN)
    sys.modules["jaxlib"] = sys  # a stand-in, removed below
    try:
        assert "jaxlib" in forbidden_modules()
    finally:
        del sys.modules["jaxlib"]
    assert "ray_tracing_tpu" not in forbidden_modules() or "ray_tracing_tpu" in sys.modules


def test_run_exits_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "zy_scene.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=CHECKOUT, timeout=600,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2
    assert out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr
