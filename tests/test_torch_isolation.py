"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the entry points refuse to run on
the CPU unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, device
from repro_torch import estimator as test_

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SMOKE = REPO / "chip_smoke.py"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_and_fits_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "import repro_torch, repro_torch.convert, repro_torch.kernels\n"
        "from repro_torch.core import graphs\n"
        "from repro_torch.estimator import ConcordEstimator, SolverConfig\n"
        "prob = graphs.make_problem('chain', p=16, n=60, seed=0)\n"
        "est = ConcordEstimator(lam1=0.3, config=SolverConfig(\n"
        "    backend='reference', variant='cov', device='cpu',\n"
        "    use_pallas=True, sparse_matmul='on', sparse_block=4,\n"
        "    sparse_threshold=0.5))\n"
        "est.fit(np.asarray(prob.x, np.float64))\n"
        "assert est.report_.converged\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device()
    with pytest.raises(RuntimeError):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_do_not_fall_back_to_the_cpu(no_cuda):
    s = np.eye(8)
    est = test_.ConcordEstimator(lam1=0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        est.fit_cov(s, n_samples=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        est.fit(np.ones((10, 8)))
    with pytest.raises(RuntimeError, match="CUDA"):
        est.fit_path(s=s, lam1_grid=[0.3], n_samples=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_.fit(s=s, lam1=0.3, n_samples=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.omega_from_numpy(s)


def test_data_and_cli_entry_points_do_not_fall_back_to_the_cpu(
        no_cuda, tmp_path):
    from repro_torch import data
    from repro_torch.launch import gram, solve
    x = np.random.default_rng(0).standard_normal((40, 6))
    est = test_.ConcordEstimator(lam1=0.3)
    for call in (lambda: data.compute_gram(x),
                 lambda: data.make_scenario("banded", p=8),
                 lambda: est.fit(iter([x])),
                 lambda: est.fit(x, transform="rank"),
                 lambda: test_.fit(x, lam1=0.3, transform="center"),
                 lambda: solve.main(["--p", "8", "--n", "20"]),
                 lambda: gram.main(["prep", "--scenario", "hub", "--p", "8",
                                    "--n", "40", "--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_data_slice_runs_with_jax_blocked(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.launch import gram, solve\n"
        f"art = {str(tmp_path / 'art')!r}\n"
        "gram.main(['prep', '--scenario', 'banded', '--p', '24', '--n',\n"
        "           '2000', '--chunk-rows', '300', '--out', art],\n"
        "          device='cpu')\n"
        "rep = solve.main(['--from-gram', art, '--lam1', '0.3',\n"
        "                  '--backend', 'reference', '--sparse-matmul',\n"
        "                  'on', '--sparse-block', '4'], device='cpu')\n"
        "assert rep.converged\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_lm_slice_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import math, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import lm, transformer\n"
        "cfg = configs.get_smoke('h2o-danube-1.8b').with_(\n"
        "    attention_impl='flash')\n"
        "m = transformer.init_params(cfg, seed=0, device='cpu')\n"
        "t = torch.randint(0, cfg.vocab, (1, 40))\n"
        "total, aux = lm.loss_fn(cfg, m, lm.Batch(tokens=t, targets=t))\n"
        "assert math.isfinite(float(total))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_lm_entry_points_do_not_fall_back_to_the_cpu(no_cuda):
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.get_smoke("h2o_danube_1p8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params_from_numpy(cfg, {"embed": {}, "final": {},
                                           "blocks": {}})


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(SMOKE)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(SMOKE.read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
