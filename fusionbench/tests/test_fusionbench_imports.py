"""No process the benchmark runs holds JAX or the JAX package: module
names are compared by their part before the first dot, as a whole."""

import ast
import os
import subprocess
import sys

from fusionbench import harness, registry


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(["anchored_fusion_tpu_torch_x",
                                      "anchored_fusion_tpu_torch.pipeline",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["anchored_fusion_tpu.pipeline"]) == [
        "anchored_fusion_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                      "anchored_fusion_tpu"]) == [
        "anchored_fusion_tpu", "flax", "jax", "jaxlib"]


def test_a_fake_module_beside_the_port_passes():
    import types
    sys.modules["anchored_fusion_tpu_torch_x"] = types.ModuleType(
        "anchored_fusion_tpu_torch_x")
    try:
        assert "anchored_fusion_tpu_torch_x" in sys.modules
        names = [n for n in sys.modules if n != "anchored_fusion_tpu"
                 and not n.startswith(("anchored_fusion_tpu.", "jax",
                                       "flax"))]
        assert harness.forbidden_modules(names) == []
    finally:
        del sys.modules["anchored_fusion_tpu_torch_x"]


def test_the_harness_and_the_port_load_no_jax():
    # a fresh process: the test process itself may hold JAX
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from fusionbench import harness, control, generate, judge\n"
            "from fusionbench import program\n"
            "import anchored_fusion_tpu_torch.pipeline as p\n"
            "from anchored_fusion_tpu_torch.align import genome_xl\n"
            "for m in registry.names('metrics'): registry.reader(m)\n"
            "for e in registry.names('entries'): registry.entry(e)\n"
            "print(harness.forbidden_modules())\n"
            % os.path.dirname(registry.HERE))
    code = code.replace("for m in", "from fusionbench import registry\n"
                        "for m in")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(registry.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                assert not harness.forbidden_modules(names), (f, names)


def test_a_run_without_a_card_exits_nonzero_with_no_result(card_absent):
    out = subprocess.run(
        [sys.executable, os.path.join(registry.HERE, "run.py"), "--workload",
         "bulk_hg38.wts", "--seed", str(2 ** 31 + 7), "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(registry.HERE))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
