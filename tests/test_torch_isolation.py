"""The port stands alone: ``repro_torch``, its examples
(``examples/torch_*.py``) and ``chip_smoke.py`` import neither JAX nor
the JAX package, and the entry points refuse to run on the CPU unless
asked to."""
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
    return (sorted(PORT.rglob("*.py"))
            + sorted((REPO / "examples").glob("torch_*.py")) + [SMOKE])


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


def test_serve_and_obs_entry_points_do_not_fall_back_to_the_cpu(no_cuda):
    import argparse
    from repro_torch.launch import serve
    from repro_torch.obs import cli
    args = argparse.Namespace(requests=2, batch=2, p=8, n=20, lam2=0.05,
                              tol=1e-4, max_iters=20, seed=0)
    for call in (lambda: serve.serve_concord(args),
                 lambda: serve.main(["--workload", "concord", "--p", "8"]),
                 lambda: cli.main(["reconcile"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_obs_and_serve_run_with_jax_blocked(tmp_path):
    """The obs package (tracer, metrics, commwatch, CLI) and the serving
    drain import and run with JAX and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.obs, repro_torch.obs.commwatch\n"
        "from repro_torch.obs import cli, trace\n"
        "from repro_torch.launch import serve\n"
        "st = serve.main(['--workload', 'concord', '--requests', '3',\n"
        "                 '--batch', '2', '--p', '12', '--n', '40',\n"
        "                 '--obs', 'trace'], device='cpu')\n"
        "assert len(st.reports) == 3 and st.max_gap < 5e-3\n"
        f"out = {str(tmp_path / 't.json')!r}\n"
        "assert cli.main(['reconcile', '--trace-out', out],\n"
        "                device='cpu') == 0\n"
        "assert cli.main(['print', out]) == 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


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
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = configs.get_smoke("h2o_danube_1p8b")
    for call in (lambda: transformer.init_params(cfg),
                 lambda: transformer.init_cache(cfg, 1, 8),
                 lambda: convert.lm_params_from_numpy(
                     cfg, {"embed": {}, "final": {}, "blocks": {}}),
                 lambda: convert.cache_from_numpy(
                     cfg, {"k": np.zeros(1), "v": np.zeros(1),
                           "pos": np.zeros(1)}),
                 lambda: serve.main(["--arch", "h2o-danube-1.8b",
                                     "--smoke"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_lm_serving_runs_with_jax_blocked():
    """``launch.serve --workload lm --smoke`` (a dense and an MoE decoder)
    imports and runs with JAX and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.launch import serve\n"
        "for arch in ('h2o-danube-1.8b', 'olmoe-1b-7b'):\n"
        "    toks = serve.main(['--workload', 'lm', '--arch', arch,\n"
        "                       '--smoke', '--batch', '2', '--gen', '8'],\n"
        "                      device='cpu')\n"
        "    assert tuple(toks.shape) == (2, 8), toks.shape\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


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


def _example(name):
    import importlib.util
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_brain_clustering",
                                  "torch_replication_study"])
def test_examples_do_not_fall_back_to_the_cpu(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main([])


def test_clustering_and_examples_run_with_jax_blocked():
    """The Section 5 pipeline (``core.clustering`` through the brain
    example's ``run_pipeline``) imports and runs with JAX and the JAX
    package blocked."""
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"path = {str(REPO / 'examples' / 'torch_brain_clustering.py')!r}\n"
        "spec = importlib.util.spec_from_file_location('brain', path)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['brain'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "om, labels, x, nbrs, side = mod.make_region_problem(8, 4, 300)\n"
        "s = mod.sample_covariance(x, 'cpu')\n"
        "cfg = mod.SolverConfig(backend='reference', variant='cov',\n"
        "                       tol=1e-5, max_iters=250, device='cpu')\n"
        "res = mod.run_pipeline(s, 300, labels, nbrs, config=cfg,\n"
        "                       lam2_grid=(0.05,), lam1_grid=(0.16,))\n"
        "assert 0.0 < res.best[0] <= 1.0 and len(res.baseline) == 3\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_train_entry_points_do_not_fall_back_to_the_cpu(no_cuda, tmp_path):
    """``train()``, ``launch.train``, the example, the data sources and
    ``init_params`` raise without a card unless asked for the CPU."""
    import importlib.util
    from repro_torch import configs
    from repro_torch.launch import train as cli
    from repro_torch.train import data, loop
    cfg = configs.get_smoke("mamba2_130m")
    tc = loop.TrainerConfig(seq_len=16, global_batch=2, steps=1,
                            log_every=0)
    spec = importlib.util.spec_from_file_location(
        "torch_lm_train", REPO / "examples" / "torch_lm_train.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    src = data.SyntheticLM(vocab=64, seq_len=8, global_batch=2)
    for call in (lambda: loop.train(cfg, tc),
                 lambda: cli.main(["--arch", "mamba2-130m", "--smoke",
                                   "--steps", "1", "--seq-len", "16"]),
                 lambda: example.main(["--steps", "1", "--ckpt-dir",
                                       str(tmp_path)]),
                 lambda: src.batch_at(0),
                 lambda: src.device_batch_at(0),
                 lambda: data.SyntheticFrames(4, 8, 2).frames_at(0),
                 lambda: data.make_source(cfg, 8, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert loop.train(cfg, tc, device="cpu", log=lambda *a: None
                      ).final_step == 1


def test_train_slice_runs_with_jax_blocked(tmp_path):
    """``launch.train`` trains, checkpoints and resumes with JAX and the
    JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import math\n"
        "from repro_torch.launch import train\n"
        f"argv = ['--arch', 'whisper-small', '--smoke', '--seq-len', '16',\n"
        f"        '--batch', '2', '--ckpt-dir', {str(tmp_path)!r}]\n"
        "res = train.main(argv + ['--steps', '2'], device='cpu')\n"
        "res = train.main(argv + ['--steps', '3'], device='cpu')\n"
        "assert res.final_step == 3 and len(res.losses) == 1\n"
        "assert all(math.isfinite(x) for x in res.losses)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
