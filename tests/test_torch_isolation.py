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


def test_distributed_solve_runs_with_jax_blocked(tmp_path):
    """Two processes joined the way torchrun joins them (WORLD_SIZE,
    RANK, env://) run ``launch.solve --backend distributed`` with JAX and
    the JAX package blocked, and agree."""
    import socket
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.launch import gram, solve\n"
        f"art = {str(tmp_path / 'art')!r}\n"
        "rep = solve.main(['--from-gram', art, '--lam1', '0.3',\n"
        "                  '--backend', 'distributed', '--sparse-matmul',\n"
        "                  'on', '--sparse-block', '4'], device='cpu')\n"
        "assert rep.converged and rep.n_devices == 2, rep\n"
        "assert not torch.distributed.is_initialized()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok', rep.iters, rep.ls_total, float(rep.omega.sum()))\n")
    from repro_torch.launch import gram
    gram.main(["prep", "--scenario", "banded", "--p", "24", "--n", "2000",
               "--out", str(tmp_path / "art")], device="cpu")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [pr.communicate(timeout=300) for pr in procs]
    for pr, (out, err) in zip(procs, outs):
        assert pr.returncode == 0, err[-3000:]
    lines = [out.strip().splitlines()[-1] for out, _ in outs]
    assert lines[0].startswith("ok") and lines[0] == lines[1]


def test_init_process_group_does_not_pick_gloo_on_its_own(no_cuda):
    """No device and no card: the CUDA default raises, as every entry
    point does; gloo is chosen only by asking for the CPU."""
    import torch.distributed as dist
    from repro_torch.comm import group
    with pytest.raises(RuntimeError, match="device='cpu'"):
        group.init_process_group(world_size=1, rank=0,
                                 init_method="tcp://localhost:1")
    with pytest.raises(ValueError, match="NCCL"):
        group.init_process_group("cpu", backend="nccl", world_size=1,
                                 rank=0, init_method="tcp://localhost:1")
    assert not dist.is_initialized()


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
