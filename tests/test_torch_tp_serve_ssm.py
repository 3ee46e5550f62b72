"""Prefill and decode on a mesh for the ssm, hybrid and audio families
(``lm.make_prefill`` / ``make_decode_step`` with ``mesh=``: the Mamba2
block on this rank's blocks of its ``conv`` and ``h`` state, Zamba2's
per-group rings, Whisper's encoder output held split) against the JAX
reference's sharded program on the CPU: the Mamba2, Zamba2 and Whisper
smoke configs, float32, a 30-token prompt and 4 decode steps on the
meshes (data, model) = (1, 4) and (2, 2) at global batches of 4 and 1,
the port on 4 gloo ranks and the reference on 4 virtual XLA devices; the
harness is ``_torch_tp_serve``'s.

The layouts (the reference's ``cache_shardings``): Mamba2's 160 conv
channels x | B | C split over "model" in blocks that do not follow a
rank's 2 (or 4) SSM heads, ``h`` by heads; Zamba2's ``mamba`` leaves are
stacked (groups, layers), its 4 kv heads split over "model"; Whisper's
``enc_out`` splits its width over "data" at B 1 on (2, 2), where the
self-attention ring splits its slots over "data".
"""
import pytest

import _torch_parity  # noqa: F401  (pins torch to one thread)
import _torch_tp_serve as ts
from test_torch_ranks import RankPool

CASES = (("mamba2", "mamba2_130m", {}, 32, 30),
         ("zamba2", "zamba2_7b", {}, 32, 30),
         ("whisper", "whisper_small", {}, 32, 30))
CMB = ts.cases_mesh_batch(CASES)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ts.run_reference(CASES, tmp_path_factory.mktemp("tp_serve_ssm"))


@pytest.fixture(scope="module")
def runs(reference):
    pool = RankPool(4)
    try:
        yield ts.run_port(pool, CASES, reference)
    finally:
        pool.close()


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_prefill_logits_match_reference(reference, runs, case, shape,
                                        batch):
    """Prefill's last logits (Whisper's after encoding its frames, whose
    width a rank holds a block of), gathered, within TOL."""
    ts.check_logits(reference, runs[case[0], shape, batch], case[0], shape,
                    batch)


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_cache_matches_reference_after_every_call(reference, runs, case,
                                                  shape, batch):
    """``conv``, ``h``, the rings and ``enc_out``, gathered, after prefill
    and after each decode step within TOL (``pos`` exact): a rank's block
    of the new conv rows taken from the wrong channels shows here."""
    ts.check_caches(reference, runs[case[0], shape, batch], case[0], shape,
                    batch)


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_greedy_tokens_match_reference(reference, runs, case, shape,
                                       batch):
    ts.check_tokens(reference, runs[case[0], shape, batch], case[0], shape,
                    batch)


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_blocks_shaped_as_reference_shards(reference, runs, case, shape,
                                           batch):
    ts.check_block_shapes(reference, runs[case[0], shape, batch], case[0],
                          shape, batch)
