"""The port stands apart from the jax package: no module of it, its
command line or its spawned ranks loads jax; and a kernel's wrapper has no
CPU route for a CUDA tensor (the plain version runs only on tensors the
caller put on the CPU)."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODULES = [
    "ntt_aie_tpu_torch",
    "ntt_aie_tpu_torch.__main__",
    "ntt_aie_tpu_torch.api",
    "ntt_aie_tpu_torch.cli",
    "ntt_aie_tpu_torch.config",
    "ntt_aie_tpu_torch.dilithium",
    "ntt_aie_tpu_torch.examples",
    "ntt_aie_tpu_torch.examples.bigint_multiply",
    "ntt_aie_tpu_torch.examples.distributed_demo",
    "ntt_aie_tpu_torch.examples.pqc_serving_demo",
    "ntt_aie_tpu_torch.examples.rlwe_demo",
    "ntt_aie_tpu_torch.examples.serving_matform_demo",
    "ntt_aie_tpu_torch.fields",
    "ntt_aie_tpu_torch.goldilocks_plan",
    "ntt_aie_tpu_torch.kyber",
    "ntt_aie_tpu_torch.native_oracle",
    "ntt_aie_tpu_torch.plan",
    "ntt_aie_tpu_torch.reference",
    "ntt_aie_tpu_torch.ring_layers",
    "ntt_aie_tpu_torch.rns",
    "ntt_aie_tpu_torch.twiddles",
    "ntt_aie_tpu_torch.ops.colpass",
    "ntt_aie_tpu_torch.ops.crt",
    "ntt_aie_tpu_torch.ops.fused_fourstep",
    "ntt_aie_tpu_torch.ops.gl_colpass",
    "ntt_aie_tpu_torch.ops.modops",
    "ntt_aie_tpu_torch.ops.nested_colpass",
    "ntt_aie_tpu_torch.ops.pointwise",
    "ntt_aie_tpu_torch.ops.reductions",
    "ntt_aie_tpu_torch.ops.ring_layers",
    "ntt_aie_tpu_torch.ops.stages",
    "ntt_aie_tpu_torch.parallel",
    "ntt_aie_tpu_torch.parallel.fourstep",
    "ntt_aie_tpu_torch.parallel.launch",
    "ntt_aie_tpu_torch.parallel.mesh",
    "ntt_aie_tpu_torch.parallel.runs",
    "ntt_aie_tpu_torch.profiling",
    "ntt_aie_tpu_torch.profiling.plots",
    "ntt_aie_tpu_torch.profiling.roofline",
    "ntt_aie_tpu_torch.profiling.scaling",
    "ntt_aie_tpu_torch.profiling.sweep",
    "ntt_aie_tpu_torch.profiling.trace",
    "ntt_aie_tpu_torch.scripts",
    "ntt_aie_tpu_torch.scripts.flat_splits",
    "ntt_aie_tpu_torch.scripts.fused_turns",
    "ntt_aie_tpu_torch.scripts.proto_nested_colpass",
    "ntt_aie_tpu_torch.scripts.sass_count",
    "ntt_aie_tpu_torch.utils.device",
    "ntt_aie_tpu_torch.utils.streaming",
    "ntt_aie_tpu_torch.utils.timing",
]


def _run(args, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
            "                                            'ntt_aie_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_port_module_is_listed():
    pkg = ROOT / "ntt_aie_tpu_torch"
    found = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in pkg.rglob("*.py")
    }
    assert found - {"ntt_aie_tpu_torch.ops", "ntt_aie_tpu_torch.utils"} \
        == set(MODULES)


def test_cli_runs_without_jax_and_without_a_card():
    """python -m ntt_aie_tpu_torch info lists no card here and exits 0;
    the interpreter's import log holds neither jax nor the JAX package."""
    res = _run(["-X", "importtime", "-m", "ntt_aie_tpu_torch", "info"])
    assert res.returncode == 0, res.stderr
    assert "devices: 0" in res.stdout and "p469762049" in res.stdout
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in res.stderr.splitlines()
                if line.startswith("import time:")]
    assert "ntt_aie_tpu_torch.cli" in imported
    bad = [m for m in imported
           if m == "jax" or m.startswith(("jax.", "jaxlib", "ntt_aie_tpu."))
           or m == "ntt_aie_tpu"]
    assert not bad, bad


def test_chip_smoke_refuses_without_cuda():
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_kernel_source_ships_with_the_package():
    csrc = ROOT / "ntt_aie_tpu_torch" / "csrc"
    for name, replaces in (
            ("colpass.cu", "ntt_aie_tpu/ops/pallas_ntt.py::build_colpass"),
            ("gl_colpass.cu", "ntt_aie_tpu/ops/pallas_gl.py::build_gl_colpass"),
            ("fused_fourstep.cu",
             "ntt_aie_tpu/ops/pallas_ntt.py::build_fused_fourstep"),
            ("nested_colpass.cu",
             "scripts/proto_nested_colpass.py::nested_colpass"),
            ("bfly_probe.cu", "ntt_aie_tpu/profiling/roofline.py"),
            ("crt.cu", "ntt_aie_tpu/ops/crt.py::make_crt_combine"),
            ("ring_layers.cu", "ntt_aie_tpu/ring_layers.py::layered_fwd")):
        text = (csrc / name).read_text()
        assert replaces in text
        assert "extern \"C\"" in text


def test_nested_script_runs_without_jax():
    """check runs through the plain version on request; bench needs the
    card and says so."""
    mod = "ntt_aie_tpu_torch.scripts.proto_nested_colpass"
    code = ("import importlib, sys\n"
            f"assert importlib.import_module({mod!r}).main(\n"
            "    ['check', '--device', 'cpu']) == 0\n"
            "bad = [m for m in sys.modules if m == 'jax'\n"
            "       or m.startswith(('jax.', 'ntt_aie_tpu.'))]\n"
            "sys.exit(3 if bad else 0)\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stdout + res.stderr
    assert '"check": "ok"' in res.stdout
    res = _run(["-m", mod, "bench", "2", "1"])
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_spawned_ranks_import_no_jax():
    """The distributed plan's ranks (run_spmd, spawn start method) hold
    neither jax nor the JAX package, though the process that spawns them
    here has both."""
    import jax  # noqa: F401 (the parent holds it)

    from ntt_aie_tpu_torch.parallel import launch, runs

    for got in launch.run_spmd(runs.probe, 2, backend="gloo",
                               device_type="cpu"):
        assert got == {"jax": False, "ntt_aie_tpu": False}
