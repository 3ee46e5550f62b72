"""Card-only: the streaming Gram on the card against the same stream
accumulated on the CPU — host chunks through the pinned staging buffer
in both memory orders (row-major and column-major ``.npy`` shards),
chunks that are tensors on the card, the rank transform and the
scenario sampler.

Marked ``gpu``; without a card they skip.  The module imports neither JAX
nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_data_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.data import (compute_gram, make_scenario, open_shards,
                              write_shards)

from _torch_parity import cuda  # noqa: F401

AGREE = 1e-10


@pytest.fixture(scope="module")
def x_host():
    return np.random.default_rng(5).standard_normal((1000, 67))


def _close(a, b, tol=AGREE):
    assert a.s.dtype == b.s.dtype == torch.float64
    assert (a.n, a.n_chunks, a.source_dtype) == (b.n, b.n_chunks,
                                                 b.source_dtype)
    assert float((a.s.cpu() - b.s.cpu()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("transform", ["none", "center", "standardize"])
def test_shards_stream_on_card_as_on_cpu(cuda, tmp_path, x_host, order,
                                         transform):
    # one shard, so the file keeps the array's memory order; its row
    # chunks are strided views when the order is "F"
    x = np.asarray(x_host.astype(np.float32), order=order)
    write_shards(x, tmp_path, rows_per_shard=len(x))
    assert np.load(next(tmp_path.glob("*.npy")), mmap_mode="r").flags[
        "F_CONTIGUOUS" if order == "F" else "C_CONTIGUOUS"]
    got = compute_gram(open_shards(tmp_path, chunk_rows=150),
                       transform=transform, device=cuda)
    want = compute_gram(open_shards(tmp_path, chunk_rows=150),
                        transform=transform, device="cpu")
    assert got.s.device.type == "cuda"
    _close(got, want)


@pytest.mark.gpu
def test_card_tensor_chunks_and_rank(cuda, x_host):
    chunks = [torch.from_numpy(x_host[lo:lo + 250]).to(cuda)
              for lo in range(0, 1000, 250)]
    _close(compute_gram(chunks, transform="center", device=cuda),
           compute_gram(x_host, transform="center", chunk_rows=250,
                        device="cpu"))
    _close(compute_gram(x_host, transform="rank", chunk_rows=300,
                        device=cuda),
           compute_gram(x_host, transform="rank", chunk_rows=300,
                        device="cpu"))


@pytest.mark.gpu
def test_scenario_on_card_as_on_cpu(cuda):
    got = make_scenario("hub", p=48, cond=12.0, seed=2, device=cuda)
    want = make_scenario("hub", p=48, cond=12.0, seed=2, device="cpu")
    assert float((got.omega.cpu() - want.omega).abs().max()) <= 1e-12
    for a, b in zip(got.source(700, chunk_rows=256, seed=3).chunks(),
                    want.source(700, chunk_rows=256, seed=3).chunks()):
        assert a.is_cuda and a.is_contiguous()
        assert float((a.cpu() - b).abs().max()) <= 1e-12
