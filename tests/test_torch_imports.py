"""Import hygiene of the port and its configuration defaults.

In a fresh interpreter, importing every module of ``anchored_fusion_tpu_torch``
(and ``chip_smoke.py``) must load neither JAX nor the JAX package.  Module
names are compared exactly: ``anchored_fusion_tpu_torch`` shares its prefix
with ``anchored_fusion_tpu``.
"""

import dataclasses
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import anchored_fusion_tpu.config as jcfg
import anchored_fusion_tpu_torch
import anchored_fusion_tpu_torch.config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        anchored_fusion_tpu_torch.__path__, "anchored_fusion_tpu_torch."))


_PROBE = """
import importlib, json, sys
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
import runpy
runpy.run_path(sys.argv[2], run_name="chip_smoke_import_probe")
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "anchored_fusion_tpu")
             or m.startswith(("jax.", "jaxlib.", "anchored_fusion_tpu.")))
print(json.dumps(bad))
"""


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "anchored_fusion_tpu_torch.ops.sw_cuda" in mods
    assert "anchored_fusion_tpu_torch.pipeline" in mods
    for name in ("cli.bulk", "cli.common", "models.filter_cnn",
                 "models.train", "models.negative", "models.weights",
                 "io.native", "utils.msgpack_lite", "utils.log",
                 "align.genome_xl", "parallel.sharded_genome",
                 "bench.hg_scale", "bench.hg_e2e", "cli.sc", "io.sam",
                 "io.bam", "models.positive", "models.bilstm",
                 "models.svm", "parallel.mesh", "parallel.collectives",
                 "parallel.distributed", "parallel.launch",
                 "bench.downsample", "bench.make_positive_assets",
                 "bench.negative_scale", "bench.depth_sweep",
                 "bench.surrogate", "bench.real_depth", "bench.headline",
                 "ops.anchor", "ops.anchor_cuda", "bench.anchor_bench"):
        assert f"anchored_fusion_tpu_torch.{name}" in mods, name
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(mods),
         os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_HELP_PROBE = """
import json, runpy, sys
sys.argv = [sys.argv[1], "--help"]
try:
    runpy.run_module("anchored_fusion_tpu_torch.cli." + sys.argv[0],
                     run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "anchored_fusion_tpu")
             or m.startswith(("jax.", "jaxlib.", "anchored_fusion_tpu.")))
print(json.dumps(bad))
"""


def _check_cli_help(name: str):
    """``python -m anchored_fusion_tpu_torch.cli.<name> --help`` prints the
    JAX CLI's flags and loads no JAX."""
    import importlib
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _HELP_PROBE, name],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == []
    jparser = importlib.import_module(f"anchored_fusion_tpu.cli.{name}")
    tparser = importlib.import_module(f"anchored_fusion_tpu_torch.cli.{name}")
    flags = lambda p: sorted(a.dest for a in p._actions)  # noqa: E731
    assert flags(tparser.build_parser()) == flags(jparser.build_parser())
    assert "--not_train_filter_model" in proc.stdout
    return proc.stdout


def test_bulk_cli_help_imports_no_jax():
    _check_cli_help("bulk")


def test_sc_cli_help_imports_no_jax():
    assert "--fastq_dir" in _check_cli_help("sc")


@pytest.mark.parametrize("name", ["AlignConfig", "CallConfig",
                                  "FilterModelConfig", "PipelineConfig",
                                  "StagePreset"])
def test_config_defaults_equal(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf = {f.name: f for f in dataclasses.fields(jc)}
    tf = {f.name: f for f in dataclasses.fields(tc)}
    assert list(jf) == list(tf)
    if name == "StagePreset":
        for preset in ("HOMOLOG_PRESET", "FINE_BLOCK_PRESET",
                       "CANDIDATE_LEAK_PRESET", "ANCHORED_SPLIT_PRESET",
                       "JUNCTION_LINEARITY_PRESET",
                       "NEGATIVE_LINEARITY_PRESET"):
            assert (dataclasses.asdict(getattr(tcfg, preset))
                    == dataclasses.asdict(getattr(jcfg, preset)))
        return
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())
