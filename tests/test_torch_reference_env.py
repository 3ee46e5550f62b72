"""The environment of the JAX reference subprocesses that the port's
parity harnesses start (``_torch_parity.reference_env``): XLA's CPU dot
products pinned to one thread (``PINNED_XLA_FLAGS``), so the yardstick's
float32 bits cannot move with the size of XLA's thread pool, and every
harness that starts a reference builds its environment there and nowhere
else."""
import os
import pathlib
import re
import subprocess
import sys

from _torch_parity import PINNED_XLA_FLAGS, SRC, reference_env

TESTS = pathlib.Path(__file__).resolve().parent
#: the harnesses that start a JAX reference subprocess
HARNESSES = ("_torch_tp.py", "_torch_tp_serve.py", "test_torch_distributed.py",
             "test_torch_train_mp.py", "test_torch_sharding.py",
             "torch_f32_spread.py")


def test_reference_env_pins_xla_threads():
    """The flags pin Eigen's threads and set the device count asked for;
    ``src`` comes first on the path."""
    assert "--xla_cpu_multi_thread_eigen=false" in PINNED_XLA_FLAGS.split()
    for n in (None, 4, 8):
        env = reference_env(n)
        flags = env["XLA_FLAGS"].split()
        for flag in PINNED_XLA_FLAGS.split():
            assert flag in flags
        count = [f for f in flags
                 if f.startswith("--xla_force_host_platform_device_count")]
        assert count == ([] if n is None else
                         [f"--xla_force_host_platform_device_count={n}"])
        assert env["PYTHONPATH"].split(os.pathsep)[0] == SRC


def test_jax_starts_under_the_pinned_flags():
    """XLA knows the flags (it aborts on an unknown one) and gives the
    device count asked for."""
    env = dict(reference_env(4), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.device_count())"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-1] == "4"


def test_every_harness_builds_its_reference_env_there():
    """No test file of the port sets ``XLA_FLAGS`` or a device count
    itself; each harness that starts a reference calls
    ``reference_env``.  (The diagnostic ``torch_f32_spread.py`` also runs
    an unpinned reference on purpose, to measure what the pin changes.)"""
    files = (sorted(TESTS.glob("test_torch_*.py"))
             + sorted(TESTS.glob("_torch_*.py")))
    for f in files:
        if f.name in ("_torch_parity.py", pathlib.Path(__file__).name):
            continue
        text = f.read_text()
        assert "xla_force_host_platform_device_count" not in text, f.name
        assert not re.search(r"""\[["']XLA_FLAGS["']\]\s*=""", text), f.name
        assert "XLA_FLAGS=" not in text, f.name
    for name in HARNESSES:
        assert "reference_env(" in (TESTS / name).read_text(), name
